// Backward of the GQA flash attention kernel K11 (flash_attention.cu).  The
// reference has no backward kernel: it differentiates its full attention with
// XLA (repro/models/attention.py, train/steps.py).  The plain version is
// kernels/flash_attention/ref.py::flash_attention_bwd.
//
// q/o/do (B, Sq, H, Dh), k/v (B, Sk, KV, Dh), f32 or bf16, in the framework
// layout; lse (B, H, Sq) f32, the forward's row log-sum-exp in base e (m +
// log l, flash_attention.cu); dq (B, Sq, H, Dh), dk/dv (B, Sk, KV, Dh) in the
// operands' type; drow (B, H, Sq) f32 scratch.  The mask is the forward's:
// query row r at position Sk - Sq + r, visible iff causal `col <= pos`,
// window `(pos - col) < window` OR `col < prefix`, col < Sk; scores s =
// (q·k)·scale, softcapped `tanh(s / cap) * cap` where cap > 0.  p = exp(s -
// lse), D = rowsum(do·o), ds = p∘(do·vᵀ - D)·(1 - tanh²); dq = scale·ds·k,
// dk = scale·dsᵀ·q, dv = pᵀ·do.  All math in f32, one rounding to the output
// type at the end.
//
// Two kernels, one after the other on the caller's stream (one launch of
// the wrapper), and a third where the second splits heads:
//   1. dq: D for its rows (written to drow for the second kernel), then one
//      pass over the key tiles: s and dp, p and ds, dq += ds·k.
//   2. dk/dv: one CTA per (batch, kv head, tile of keys) and, in bf16, chunk
//      of hs query heads of the kv head; loops over its heads and, for each,
//      over the query tiles (heads first, then tiles, a fixed order),
//      re-forms p and ds from lse and drow, and accumulates dv = pᵀ·do and
//      dk = scale·dsᵀ·q for its keys.
//   3. (bf16, more than one chunk) flash_attention_bwd_sum: each chunk's
//      f32 sums, written by 2. to scratch, added in chunk order and rounded.
// Every output element is summed by one thread (or one mma fragment) in a
// fixed order: no atomics, so two runs give the same bits.  Tiles outside the
// mask of every row of the pair of tiles (the forward's block-skip test,
// reference kernel.py:47-57) are not visited, by the CTA nor by a warp.
// CTAs are numbered so the longest causal rows (dq) and the first keys
// (dk/dv, which most rows see) start first.
//
// bf16 instance (flash_attention_bwd_{dq,dkdv}_bf16_mma): all five products
// on the tensor cores, mma.sync.m16n8k16 bf16 -> f32 with ldmatrix operands,
// built as the forward is.
//   * dq: the forward's CTA, 4 warps, 64 (query row, head) pairs m = r·GC +
//     gi over the GC = min(G, 64) heads of one kv head, so one K/V tile feeds
//     every head.  Q and dO stay in shared memory; K/V tiles of BK keys (64
//     up to Dh 128, 32 above) double-buffered with cp.async.  S = Q·Kᵀ and
//     dP = dO·Vᵀ one bf16 pass each (a bf16 product is exact in f32), then
//     `* scale`, the softcap and the edge-tile mask as the forward; p =
//     exp2f((s - lse)·log2 e), the forward's exp; ds = p∘(dp - D)·slope in
//     registers.  dQ += dS·K takes ds as three bf16 pieces (hi = bf16(ds),
//     mid, lo: 24 significand bits whole, the forward's p) in A fragments,
//     smallest first: the S accumulator's layout is the A layout.  K is
//     read through ldmatrix.trans, as the forward reads V.  `* scale` after
//     the sum.
//   * dk/dv: 4 warps; a warp owns 16 keys (rows of Sᵀ) and DP / DSPLIT
//     head dims of their dk and dv.  DSPLIT = 1 up to Dh 128 (64 keys a
//     CTA); at DP 160 and 256 two warps share 16 keys and split the head
//     dims (32 keys a CTA), since dk + dv cost DP / DSPLIT f32 registers a
//     thread: those two warps both form Sᵀ and dPᵀ.  K and V stay in shared
//     memory; Q, dO, lse and D tiles of BM query rows (64 up to DP 64, 32
//     above) double-buffered.  Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ one pass each; pᵀ
//     and dsᵀ split into three bf16 pieces as A fragments; dV += Pᵀ·dO and
//     dK += dSᵀ·Q with dO and Q through ldmatrix.trans.
//   * The head split (hs, kernel.py::bwd_heads_a_cta): a causal key tile's
//     CTA carries 1 to Sq / BM query tiles, so with all G heads in one CTA
//     the first keys' CTAs alone set the launch's time (256 CTAs at the
//     tinyllama train shape, all resident at once).  Chunks of heads bring
//     the CTAs to about 1,024, longest first; each chunk's dk and dv go to
//     f32 scratch and kernel 3 sums them in order.
//   * dS·K, Pᵀ·dO and dSᵀ·Q go PG = 4 output column pairs at a time: their
//     B fragments first, then the lo products of all, the mid, the hi.
//   * Passes: 13 bf16 passes of 2·B·H·Dh·(visible pairs) up to Dh 128 (S
//     and dP in both kernels, three for each of dQ, dK, dV); 15 at DSPLIT 2.
//     The bound (chip_smoke.py) counts 11: S and dP once.
//   * Registers: the dq kernel asks for 4 CTAs an SM up to DP 64 (128
//     registers a thread), 2 above; the dk/dv kernel for 2.  ptxas's
//     counts for each instance are in PERF.md; none spills.
//   * Rows padded by 8 elements keep ldmatrix's eight row reads on distinct
//     banks without a swizzle.  Dh is padded with zeros to DP = 32, 64,
//     128, 160, 256 in shared memory; every k-step runs.  A padding row
//     (past Sq, or a head past G in the dq CTA) takes lse = 1e30, so its p
//     is 0.
//   Shared memory (row stride DP + 8, bf16): dq (128 + 4·BK)·(DP + 8)·2 B +
//   512 B; dk/dv (2·BN + 4·BM)·(DP + 8)·2 B + 16·BM B.
//
// f32 instance (flash_attention_bwd_{dq,dkdv}_kernel): the first design,
// kept for f32 operands (the f32 model and check rows): products as f32 FMAs
// on the CUDA cores, 256 threads a CTA as a 16 × 16 grid (ty, tx), a thread
// owning rows ty + 16·i and columns tx + 16·j of each product; operands
// staged in shared memory as f32 with an odd row stride (DP + 1, BN + 1);
// BM × BN = 64 × 64 up to DP 128, 64 × 32 at 160 and 32 × 32 at 256.  It
// reads the same lse; dq's CTA is one (batch, head, tile of BM rows).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float PAD_LSE = 1e30f;  // a padding row's lse: exp(s - 1e30) = 0

__device__ __forceinline__ bool tile_skipped(int c0, int c1, int rlo, int rhi,
                                             int sk, int causal, int window,
                                             int prefix) {
  return c0 >= sk || (causal && c0 > rhi) ||
         (window > 0 && rlo - c1 >= window && c0 >= prefix);
}

__device__ __forceinline__ bool tile_unmasked(int c0, int c1, int rlo,
                                              int rhi, int sk, int causal,
                                              int window, int prefix) {
  return c1 < sk && (!causal || c1 <= rlo) &&
         (window <= 0 || rhi - c0 < window || c1 < prefix);
}

__device__ __forceinline__ bool visible(int col, int pos, int sk, int causal,
                                        int window, int prefix) {
  return col < sk && (!causal || col <= pos) &&
         (window <= 0 || pos - col < window || col < prefix);
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

// ------------------------------------------------------- f32 (CUDA cores)

constexpr int TY = 16;
constexpr int TX = 16;
constexpr int THREADS = TY * TX;

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
      (2 * BM + 2 * BN) * LD + 2 * BM * LDP + 2 * BM;
};

// Rows [r0, r0 + n) of head `hd` of a (B, S, heads, Dh) f32 tensor, batch
// `b`, into dst[n][DP + 1]; zeros past S and past Dh.
template <int DP>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int b, int r0, int n, int s, int heads,
                                      int hd, int dh) {
  for (int i = threadIdx.x; i < n * DP; i += THREADS) {
    const int r = i / DP;
    const int d = i % DP;
    float x = 0.f;
    if (r0 + r < s && d < dh)
      x = src[(((int64_t)b * s + r0 + r) * heads + hd) * dh + d];
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

// The sum over the 16 lanes of a half-warp (the threads of one ty).
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
    flash_attention_bwd_dq_kernel(const float* __restrict__ q,
                                  const float* __restrict__ k,
                                  const float* __restrict__ v,
                                  const float* __restrict__ o,
                                  const float* __restrict__ dout,
                                  const float* __restrict__ lse,
                                  float* __restrict__ dq,
                                  float* __restrict__ drow, int sq, int sk,
                                  int h, int kvh, int dh, int causal,
                                  int window, int prefix, float scale,
                                  float cap) {
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

  // D = rowsum(do·o) for this thread's rows, each half-warp one row, and
  // the forward's lse
  float d_row[MI], lse_r[MI];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = ty + TY * i;
    float part = 0.f;
    if (r0 + r < sq)
      for (int d = tx; d < dh; d += TX)
        part = fmaf(do_s[r * C::LD + d],
                    o[(((int64_t)b * sq + r0 + r) * h + hd) * dh + d], part);
    d_row[i] = half_warp_sum(part);
    const int64_t row = ((int64_t)b * h + hd) * sq + r0 + r;
    lse_r[i] = r0 + r < sq ? lse[row] : PAD_LSE;
    if (tx == 0 && r0 + r < sq) drow[row] = d_row[i];
  }

  float acc_q[MI][DJ];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_q[i][j] = 0.f;
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
        const float p = s > NEG_INF ? expf(s - lse_r[i]) : 0.f;
        ds_s[(ty + TY * i) * C::LDP + tx + TX * j] =
            p * (acc_p[i][j] - d_row[i]) * slope;
      }
    }
    __syncthreads();
    rows_dot_cols<DP, MI, DJ>(acc_q, ds_s, C::LDP, k_s, BN, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = r0 + ty + TY * i;
    if (r >= sq) continue;
    float* dst = dq + (((int64_t)b * sq + r) * h + hd) * dh;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + TX * j;
      if (d < dh) dst[d] = acc_q[i][j] * scale;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
    flash_attention_bwd_dkdv_kernel(const float* __restrict__ q,
                                    const float* __restrict__ k,
                                    const float* __restrict__ v,
                                    const float* __restrict__ dout,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ drow,
                                    float* __restrict__ dk,
                                    float* __restrict__ dv, int sq, int sk,
                                    int h, int kvh, int dh, int causal,
                                    int window, int prefix, float scale,
                                    float cap) {
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
  float* st_s = ds_s + BM * C::LDP;  // [2][BM]: lse, D

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
        const int64_t row = ((int64_t)b * h + hd) * sq + r0 + r;
        const bool ok = r0 + r < sq;
        st_s[r] = ok ? lse[row] : PAD_LSE;
        st_s[BM + r] = ok ? drow[row] : 0.f;
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
        const float ls = st_s[r], dd = st_s[BM + r];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float slope;
          const float s = score(acc_s[i][j], scale, cap,
                                row_ok && visible(c0 + tx + TX * j, pos, sk,
                                                  causal, window, prefix),
                                &slope);
          const float p = s > NEG_INF ? expf(s - ls) : 0.f;
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
        dk[base + d] = acc_k[i][j] * scale;
        dv[base + d] = acc_v[i][j];
      }
    }
  }
}

template <int DP>
int launch_f32_dp(const float* q, const float* k, const float* v,
                  const float* o, const float* dout, const float* lse,
                  float* dq, float* dk, float* dv, float* drow, long long b,
                  long long sq, long long sk, long long h, long long kvh,
                  long long dh, long long causal, long long window,
                  long long prefix, float scale, float cap,
                  cudaStream_t stream) {
  using C = Tiles<DP>;
  const size_t dq_bytes = C::DQ_FLOATS * sizeof(float);
  const size_t dkdv_bytes = C::DKDV_FLOATS * sizeof(float);
  static bool ready = false;  // one attribute call per instance
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_bwd_dq_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_bytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dkdv_bytes);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const dim3 grid_q((unsigned)((sq + C::BM - 1) / C::BM), (unsigned)h,
                    (unsigned)b);
  flash_attention_bwd_dq_kernel<DP><<<grid_q, THREADS, dq_bytes, stream>>>(
      q, k, v, o, dout, lse, dq, drow, (int)sq, (int)sk, (int)h, (int)kvh,
      (int)dh, (int)causal, (int)window, (int)prefix, scale, cap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_kv((unsigned)((sk + C::BN - 1) / C::BN), (unsigned)kvh,
                     (unsigned)b);
  flash_attention_bwd_dkdv_kernel<DP>
      <<<grid_kv, THREADS, dkdv_bytes, stream>>>(
          q, k, v, dout, lse, drow, dk, dv, (int)sq, (int)sk, (int)h,
          (int)kvh, (int)dh, (int)causal, (int)window, (int)prefix, scale,
          cap);
  return (int)cudaGetLastError();
}

// --------------------------------------------------- bf16 (tensor cores)

typedef __nv_bfloat16 bf16;

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_ROWS = 16 * TC_WARPS;  // (query row, head) pairs a dq CTA
constexpr float LOG2E = 1.4426950408889634f;

template <int DP>
struct BwdShape {
  static constexpr int BK = DP <= 128 ? 64 : 32;    // keys a dq tile
  static constexpr int DSPLIT = DP <= 128 ? 1 : 2;  // dk/dv warps a 16 keys
  static constexpr int BN = 16 * TC_WARPS / DSPLIT;  // keys a dk/dv CTA
  static constexpr int BM = DP <= 64 ? 64 : 32;    // query rows a dk/dv tile
  static constexpr int LD = DP + 8;                 // smem row stride (elems)
  // output tile pairs a group of dS·K, Pᵀ·dO, dSᵀ·Q
  static constexpr int PG = DP <= 128 ? 4 : 1;
  static constexpr int PIECES = 3;  // bf16 pieces of p and ds
  // CTAs an SM asked of the register allocator
  static constexpr int DQ_MIN_CTAS = DP <= 64 ? 4 : 2;
  static constexpr int DKDV_MIN_CTAS = 2;
  static constexpr size_t DQ_SMEM =
      (size_t)(2 * TC_ROWS + 4 * BK) * LD * 2 + 2 * TC_ROWS * 4;
  static constexpr size_t DKDV_SMEM =
      (size_t)(2 * BN + 4 * BM) * LD * 2 + 4 * BM * 4;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a · b, m16n8k16, bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async_16(bf16* dst, const bf16* src,
                                            bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_0() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Eight elements from src (n of them valid) into shared memory: one
// asynchronous 16-byte copy when the rows are 16-byte aligned (vec), else
// element by element; the rest zero.
__device__ __forceinline__ void copy8(bf16* dst, const bf16* src,
                                      const bf16* base, int n, bool vec) {
  if (vec) {
    cp_async_16(dst, n > 0 ? src : base, n > 0);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[e] = e < n ? src[e] : __float2bfloat16_rn(0.f);
  }
}

// Rows [r0, r0 + n) of head `hd` of a (B, S, heads, Dh) bf16 tensor into
// dst[n][DP + 8], zeros past S and past Dh, asynchronously where vec.
template <int DP>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int b,
                                          int r0, int n, int s, int heads,
                                          int hd, int dh, bool vec) {
  constexpr int CH = DP / 8;  // 16-byte chunks a row
  for (int c = threadIdx.x; c < n * CH; c += TC_THREADS) {
    const int j = c / CH, d = (c % CH) * 8;
    const int cnt = r0 + j < s ? dh - d : 0;
    const int64_t idx = (((int64_t)b * s + r0 + j) * heads + hd) * dh + d;
    copy8(dst + j * (DP + 8) + d, cnt > 0 ? src + idx : src, src, cnt, vec);
  }
}

// Eight bf16 of a 16-byte aligned address, widened to f32.
__device__ __forceinline__ void load8(float (&x)[8], const bf16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 t;
    memcpy(&t, &w[i], 4);
    x[2 * i] = __low2float(t);
    x[2 * i + 1] = __high2float(t);
  }
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 x) {
  uint32_t u;
  memcpy(&u, &x, 4);
  return u;
}

// (x0, x1) -> three bf16x2 pieces whose f32 sum is (x0, x1) whole.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  x0 -= __low2float(h);
  x1 -= __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(x0, x1);
  x0 -= __low2float(m);
  x1 -= __high2float(m);
  hi = pack(h);
  mid = pack(m);
  lo = pack(__floats2bfloat162_rn(x0, x1));
}

// The A fragments (hi, mid, lo) of k16 step kk of a 16-row tile held in
// C fragments t[2·kk], t[2·kk + 1] (the S layout is the A layout).
template <int NT>
__device__ __forceinline__ void split_a(const float (&t)[NT][4], int kk,
                                        uint32_t (&hi)[4], uint32_t (&mid)[4],
                                        uint32_t (&lo)[4]) {
  split3(t[2 * kk][0], t[2 * kk][1], hi[0], mid[0], lo[0]);
  split3(t[2 * kk][2], t[2 * kk][3], hi[1], mid[1], lo[1]);
  split3(t[2 * kk + 1][0], t[2 * kk + 1][1], hi[2], mid[2], lo[2]);
  split3(t[2 * kk + 1][2], t[2 * kk + 1][3], hi[3], mid[3], lo[3]);
}

// acc += (lo + mid + hi) · B over output column pairs j0 .. j0 + PG - 1
// (those below NP), 16 columns from col0 + 16·j each, of a row-major
// [k][LD] operand, k rows [k0, k0 + 16) read transposed (the forward's V
// in P·V): the group's B fragments first, then the lo products of all its
// tiles, the mid, the hi (smallest piece first; 2·PG accumulators apart).
template <int LD, int NT2, int PG, int NP, int PIECES>
__device__ __forceinline__ void mma_pieces(float (&acc)[NT2][4], int j0,
                                           const uint32_t (&hi)[4],
                                           const uint32_t (&mid)[4],
                                           const uint32_t (&lo)[4],
                                           const bf16* src, int k0, int col0,
                                           int lane) {
  uint32_t bt[PG][4];
#pragma unroll
  for (int jj = 0; jj < PG; ++jj)
    if (j0 + jj < NP)
      ldsm_x4_trans(bt[jj], src + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                      LD +
                                col0 + (j0 + jj) * 16 + (lane >> 4) * 8);
  const uint32_t(*const piece[3])[4] = {&lo, &mid, &hi};
#pragma unroll
  for (int pc = 3 - PIECES; pc < 3; ++pc)
#pragma unroll
    for (int jj = 0; jj < PG; ++jj)
      if (j0 + jj < NP) {
        mma_bf16(acc[2 * (j0 + jj)], *piece[pc], bt[jj][0], bt[jj][1]);
        mma_bf16(acc[2 * (j0 + jj) + 1], *piece[pc], bt[jj][2], bt[jj][3]);
      }
}

// s = A·Xᵀ and dp = Ad·Yᵀ for one warp: A and Ad 16 rows at `a_row` of
// [.][LD] tiles, X and Y NT·8 rows from row 0 of theirs, DP / 16 k-steps
// (one bf16 pass each).
template <int DP, int NT>
__device__ __forceinline__ void two_scores(float (&s)[NT][4],
                                           float (&dp)[NT][4], const bf16* A,
                                           const bf16* Ad, int a_row,
                                           const bf16* X, const bf16* Y,
                                           int lane) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4], ad[4];
    const int aoff = (a_row + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
    ldsm_x4(a, A + aoff);
    ldsm_x4(ad, Ad + aoff);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      const int boff = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                       kk * 16 + ((lane >> 3) & 1) * 8;
      uint32_t bx[4], by[4];
      ldsm_x4(bx, X + boff);
      mma_bf16(s[2 * np], a, bx[0], bx[1]);
      mma_bf16(s[2 * np + 1], a, bx[2], bx[3]);
      ldsm_x4(by, Y + boff);
      mma_bf16(dp[2 * np], ad, by[0], by[1]);
      mma_bf16(dp[2 * np + 1], ad, by[2], by[3]);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(TC_THREADS, BwdShape<DP>::DQ_MIN_CTAS)
    flash_attention_bwd_dq_bf16_mma(const bf16* __restrict__ q,
                                    const bf16* __restrict__ k,
                                    const bf16* __restrict__ v,
                                    const bf16* __restrict__ o,
                                    const bf16* __restrict__ dout,
                                    const float* __restrict__ lse,
                                    bf16* __restrict__ dq,
                                    float* __restrict__ drow, int sq, int sk,
                                    int h, int kvh, int dh, int gc, int bq,
                                    int causal, int window, int prefix,
                                    float scale, float cap, int vec) {
  using S = BwdShape<DP>;
  constexpr int BK = S::BK, LD = S::LD;
  constexpr int NT = BK / 8;   // n8 tiles of a score tile
  constexpr int KS = BK / 16;  // k16 steps of dS·K
  constexpr int DT = DP / 8;   // n8 tiles of dq
  constexpr int CH = DP / 8;   // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [TC_ROWS][LD]
  bf16* do_s = q_s + TC_ROWS * LD;                // [TC_ROWS][LD]
  bf16* k_s = do_s + TC_ROWS * LD;                // [2][BK][LD]
  bf16* v_s = k_s + 2 * BK * LD;                  // [2][BK][LD]
  float* lse_s = reinterpret_cast<float*>(v_s + 2 * BK * LD);  // [TC_ROWS]
  float* d_s = lse_s + TC_ROWS;                                // [TC_ROWS]

  // one CTA a (batch, kv head, chunk of heads, block of query rows), the
  // blocks of the longest causal rows first
  const int g = h / kvh;
  const int nhc = (g + gc - 1) / gc;
  const int units = (int)(gridDim.x / ((sq + bq - 1) / bq));
  const int unit = blockIdx.x % units;
  const int q0 = ((sq + bq - 1) / bq - 1 - (int)(blockIdx.x / units)) * bq;
  const int b = unit / (kvh * nhc);
  const int kv = (unit / nhc) % kvh;
  const int h0 = (unit % nhc) * gc;
  const int gcn = min(gc, g - h0);                   // heads of this CTA
  const int nrows = min(bq, sq - q0);
  const int off = sk - sq;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const bool vec_ok = vec != 0;

  const int rlo = off + q0;
  const int rhi = off + q0 + nrows - 1;
  const int wr0 = (warp * 16) / gc;
  const bool warp_busy = wr0 < nrows;
  const int wlo = off + q0 + wr0;
  const int whi = off + q0 + min((warp * 16 + 15) / gc, nrows - 1);
  const int ma = warp * 16 + gq, mb = ma + 8;
  const int pos_a = off + q0 + ma / gc, pos_b = off + q0 + mb / gc;

  // Q and dO: the CTA's 64 (row, head) pairs
  for (int c = tid; c < TC_ROWS * CH; c += TC_THREADS) {
    const int m = c / CH, d = (c % CH) * 8;
    const int r = m / gc, gi = m - r * gc;
    const int n = (r < nrows && gi < gcn) ? dh - d : 0;
    const int64_t idx =
        (((int64_t)b * sq + q0 + r) * h + kv * g + h0 + gi) * dh + d;
    copy8(q_s + m * LD + d, n > 0 ? q + idx : q, q, n, vec_ok);
    copy8(do_s + m * LD + d, n > 0 ? dout + idx : dout, dout, n, vec_ok);
  }

  auto load_kv = [&](int t, int stage) {
    load_rows<DP>(k_s + stage * BK * LD, k, b, t * BK, BK, sk, kvh, kv, dh,
                  vec_ok);
    load_rows<DP>(v_s + stage * BK * LD, v, b, t * BK, BK, sk, kvh, kv, dh,
                  vec_ok);
  };
  const int ntiles = (sk + BK - 1) / BK;
  auto next_tile = [&](int t) {
    while (t < ntiles && tile_skipped(t * BK, t * BK + BK - 1, rlo, rhi, sk,
                                      causal, window, prefix))
      ++t;
    return t;
  };
  int t = next_tile(0);
  if (t < ntiles) load_kv(t, 0);
  cp_async_commit();

  // D = rowsum(do·o) from device memory while the copies fly: two threads a
  // row, 8-element chunks in turn, then their sum; and the forward's lse
  {
    const int m = tid >> 1, half = tid & 1;
    const int r = m / gc, gi = m - r * gc;
    const bool ok = r < nrows && gi < gcn;
    float acc = 0.f;
    if (ok) {
      const int64_t base =
          (((int64_t)b * sq + q0 + r) * h + kv * g + h0 + gi) * dh;
      for (int d = half * 8; d < dh; d += 16) {
        float x[8], y[8];
        if (vec_ok) {  // dh % 8 == 0: whole chunks, 16-byte loads
          load8(x, dout + base + d);
          load8(y, o + base + d);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            x[e] = d + e < dh ? __bfloat162float(dout[base + d + e]) : 0.f;
            y[e] = d + e < dh ? __bfloat162float(o[base + d + e]) : 0.f;
          }
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(x[e], y[e], acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      const int64_t row = ((int64_t)b * h + kv * g + h0 + gi) * sq + q0 + r;
      d_s[m] = ok ? acc : 0.f;
      lse_s[m] = ok ? lse[row] : PAD_LSE;
      if (ok) drow[row] = acc;
    }
  }
  __syncthreads();
  const float lse_a = lse_s[ma], lse_b = lse_s[mb];
  const float d_a = d_s[ma], d_b = d_s[mb];

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  int stage = 0;
  while (t < ntiles) {
    const int tn = next_tile(t + 1);
    if (tn < ntiles) load_kv(tn, stage ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const int c0 = t * BK;
    if (warp_busy && !tile_skipped(c0, c0 + BK - 1, wlo, whi, sk, causal,
                                   window, prefix)) {
      const bool unmasked = tile_unmasked(c0, c0 + BK - 1, wlo, whi, sk,
                                          causal, window, prefix);
      const bf16* ks = k_s + stage * BK * LD;
      const bf16* vs = v_s + stage * BK * LD;
      float s[NT][4], dp[NT][4];
      two_scores<DP, NT>(s, dp, q_s, do_s, warp * 16, ks, vs, lane);
      // ds = p∘(dp - D)·slope, p = exp(s - lse), in place of s
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float slope;
          const bool vis =
              unmasked || visible(c0 + i * 8 + tq * 2 + (e & 1),
                                  e < 2 ? pos_a : pos_b, sk, causal, window,
                                  prefix);
          const float x = score(s[i][e], scale, cap, vis, &slope);
          const float p = exp2f((x - (e < 2 ? lse_a : lse_b)) * LOG2E);
          s[i][e] = p * (dp[i][e] - (e < 2 ? d_a : d_b)) * slope;
        }
      // dQ += dS · K, ds in three bf16 pieces
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t hi[4], mid[4], lo[4];
        split_a<NT>(s, kk, hi, mid, lo);
#pragma unroll
        for (int j0 = 0; j0 < DT / 2; j0 += S::PG)
          mma_pieces<LD, DT, S::PG, DT / 2, S::PIECES>(acc, j0, hi, mid, lo, ks,
                                            kk * 16, 0, lane);
      }
    }
    __syncthreads();
    stage ^= 1;
    t = tn;
  }
  cp_async_wait_0();  // a CTA with no visible tile still has Q in flight

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = half ? mb : ma;
    const int r = m / gc;
    const int gi = m - r * gc;
    if (r >= nrows || gi >= gcn) continue;
    bf16* dst = dq + (((int64_t)b * sq + q0 + r) * h + kv * g + h0 + gi) * dh;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      const int col = i * 8 + tq * 2;
      if (col < dh) dst[col] = __float2bfloat16_rn(acc[i][2 * half] * scale);
      if (col + 1 < dh)
        dst[col + 1] = __float2bfloat16_rn(acc[i][2 * half + 1] * scale);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(TC_THREADS, BwdShape<DP>::DKDV_MIN_CTAS)
    flash_attention_bwd_dkdv_bf16_mma(const bf16* __restrict__ q,
                                      const bf16* __restrict__ k,
                                      const bf16* __restrict__ v,
                                      const bf16* __restrict__ dout,
                                      const float* __restrict__ lse,
                                      const float* __restrict__ drow,
                                      bf16* __restrict__ dk,
                                      bf16* __restrict__ dv,
                                      float* __restrict__ part, int nb,
                                      int sq, int sk, int h, int kvh, int dh,
                                      int hs, int causal, int window,
                                      int prefix, float scale, float cap,
                                      int vec) {
  using S = BwdShape<DP>;
  constexpr int BN = S::BN, BM = S::BM, LD = S::LD, DSPLIT = S::DSPLIT;
  constexpr int NT = BM / 8;       // n8 tiles of Sᵀ (query rows)
  constexpr int KS = BM / 16;      // k16 steps of Pᵀ·dO and dSᵀ·Q
  constexpr int DW = DP / DSPLIT;  // head dims of a warp's dk and dv
  constexpr int DT = DW / 8;       // their n8 tiles
  static_assert(DW % 16 == 0, "a warp's head dims in ldmatrix pairs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [BN][LD]
  bf16* v_s = k_s + BN * LD;                      // [BN][LD]
  bf16* q_s = v_s + BN * LD;                      // [2][BM][LD]
  bf16* do_s = q_s + 2 * BM * LD;                 // [2][BM][LD]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * BM * LD);  // [2][BM]
  float* d_s = lse_s + 2 * BM;                                  // [2][BM]

  // one CTA a (batch, kv head, chunk of hs heads, tile of keys), the tiles
  // of the first keys (under a causal mask, those most rows see) first
  const int g = h / kvh;
  const int ns = (g + hs - 1) / hs;  // head chunks
  const int units = nb * kvh * ns;
  const int unit = blockIdx.x % units;
  const int c0 = (int)(blockIdx.x / units) * BN;
  const int split = unit % ns;
  const int kv = (unit / ns) % kvh;
  const int b = unit / (ns * kvh);
  const int gh0 = split * hs;                // the chunk's first head
  const int ghn = min(hs, g - gh0);          // and its heads
  const int off = sk - sq;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const bool vec_ok = vec != 0;
  const int slab = warp / DSPLIT;  // its 16 keys
  const int col0 = (warp % DSPLIT) * DW;  // its head dims
  const int wc0 = c0 + slab * 16;
  const int key_a = wc0 + gq, key_b = key_a + 8;  // this thread's two keys

  load_rows<DP>(k_s, k, b, c0, BN, sk, kvh, kv, dh, vec_ok);
  load_rows<DP>(v_s, v, b, c0, BN, sk, kvh, kv, dh, vec_ok);

  // items: (head gh0 + gi, query tile qt) as gi·nqt + qt, heads first
  const int nqt = (sq + BM - 1) / BM;
  const int items = ghn * nqt;
  auto rows_of = [&](int it, int& rlo, int& rhi) {
    const int r0 = (it % nqt) * BM;
    rlo = off + r0;
    rhi = off + min(r0 + BM, sq) - 1;
  };
  auto next_item = [&](int it) {
    int rlo, rhi;
    for (; it < items; ++it) {
      rows_of(it, rlo, rhi);
      if (!tile_skipped(c0, c0 + BN - 1, rlo, rhi, sk, causal, window,
                        prefix))
        break;
    }
    return it;
  };
  auto load_q = [&](int it, int stage) {
    const int hd = kv * g + gh0 + it / nqt, r0 = (it % nqt) * BM;
    load_rows<DP>(q_s + stage * BM * LD, q, b, r0, BM, sq, h, hd, dh, vec_ok);
    load_rows<DP>(do_s + stage * BM * LD, dout, b, r0, BM, sq, h, hd, dh,
                  vec_ok);
    for (int j = tid; j < BM; j += TC_THREADS) {
      const bool ok = r0 + j < sq;
      const int64_t row = ((int64_t)b * h + hd) * sq + r0 + j;
      lse_s[stage * BM + j] = ok ? lse[row] : PAD_LSE;
      d_s[stage * BM + j] = ok ? drow[row] : 0.f;
    }
  };

  float acc_k[DT][4], acc_v[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;

  int it = next_item(0);
  if (it < items) load_q(it, 0);
  cp_async_commit();
  int stage = 0;
  while (it < items) {
    const int nx = next_item(it + 1);
    if (nx < items) load_q(nx, stage ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    int rlo, rhi;
    rows_of(it, rlo, rhi);
    if (!tile_skipped(wc0, wc0 + 15, rlo, rhi, sk, causal, window, prefix)) {
      const bool unmasked = tile_unmasked(wc0, wc0 + 15, rlo, rhi, sk,
                                          causal, window, prefix);
      const bf16* qs = q_s + stage * BM * LD;
      const bf16* dos = do_s + stage * BM * LD;
      const float* ls = lse_s + stage * BM;
      const float* ds = d_s + stage * BM;
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: rows are this warp's keys, columns
      // the tile's query rows
      float s[NT][4], dp[NT][4];
      two_scores<DP, NT>(s, dp, k_s, v_s, slab * 16, qs, dos, lane);
      // pᵀ in place of s, dsᵀ in place of dp
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = i * 8 + tq * 2 + (e & 1);
          float slope;
          const bool vis =
              unmasked || visible(e < 2 ? key_a : key_b, rlo + rr, sk,
                                  causal, window, prefix);
          const float x = score(s[i][e], scale, cap, vis, &slope);
          const float p = exp2f((x - ls[rr]) * LOG2E);
          s[i][e] = p;
          dp[i][e] = p * (dp[i][e] - ds[rr]) * slope;
        }
      // dV += Pᵀ·dO and dK += dSᵀ·Q over this warp's head dims, pᵀ and
      // dsᵀ in three bf16 pieces
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t hi[4], mid[4], lo[4];
        split_a<NT>(s, kk, hi, mid, lo);
#pragma unroll
        for (int j0 = 0; j0 < DT / 2; j0 += S::PG)
          mma_pieces<LD, DT, S::PG, DT / 2, S::PIECES>(acc_v, j0, hi, mid, lo, dos,
                                            kk * 16, col0, lane);
        split_a<NT>(dp, kk, hi, mid, lo);
#pragma unroll
        for (int j0 = 0; j0 < DT / 2; j0 += S::PG)
          mma_pieces<LD, DT, S::PG, DT / 2, S::PIECES>(acc_k, j0, hi, mid, lo, qs,
                                            kk * 16, col0, lane);
      }
    }
    __syncthreads();
    stage ^= 1;
    it = nx;
  }
  cp_async_wait_0();  // a CTA with no visible tile still has K/V in flight

  // one chunk of heads: dk and dv in bf16; more: this chunk's f32 sums
  // into part [ns][2][B·Sk·KV·Dh], for flash_attention_bwd_sum
  const int64_t n_out = (int64_t)nb * sk * kvh * dh;
  float* pk = part == nullptr ? nullptr : part + (int64_t)split * 2 * n_out;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? key_b : key_a;
    if (key >= sk) continue;
    const int64_t base = (((int64_t)b * sk + key) * kvh + kv) * dh;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + i * 8 + tq * 2 + e;
        if (col >= dh) continue;
        const float xk = acc_k[i][2 * half + e], xv = acc_v[i][2 * half + e];
        if (pk == nullptr) {
          dk[base + col] = __float2bfloat16_rn(xk * scale);
          dv[base + col] = __float2bfloat16_rn(xv);
        } else {
          pk[base + col] = xk;
          pk[n_out + base + col] = xv;
        }
      }
    }
  }
}

// dk = bf16(scale·Σ_s part[s][0]), dv = bf16(Σ_s part[s][1]), the chunks
// of heads summed in order: the dk/dv kernel's epilogue where it split the
// heads of a kv head over ns CTAs.
__global__ void __launch_bounds__(256)
    flash_attention_bwd_sum(const float* __restrict__ part, int ns,
                            int64_t n, bf16* __restrict__ dk,
                            bf16* __restrict__ dv, float scale) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float sk = 0.f, sv = 0.f;
    for (int s = 0; s < ns; ++s) {
      sk += part[(int64_t)s * 2 * n + i];
      sv += part[(int64_t)s * 2 * n + n + i];
    }
    dk[i] = __float2bfloat16_rn(sk * scale);
    dv[i] = __float2bfloat16_rn(sv);
  }
}

template <int DP>
int launch_bf16_dp(const bf16* q, const bf16* k, const bf16* v,
                   const bf16* o, const bf16* dout, const float* lse,
                   bf16* dq, bf16* dk, bf16* dv, float* drow, float* part,
                   long long b, long long sq, long long sk, long long h,
                   long long kvh, long long dh, long long hs,
                   long long causal, long long window, long long prefix,
                   float scale, float cap, cudaStream_t stream) {
  using S = BwdShape<DP>;
  static bool ready = false;  // one attribute call per instance
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_bwd_dq_bf16_mma<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::DQ_SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_bf16_mma<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)S::DKDV_SMEM);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const int g = (int)(h / kvh);
  const int gc = g < TC_ROWS ? g : TC_ROWS;
  const int bq = TC_ROWS / gc;
  const int nhc = (g + gc - 1) / gc;
  const int ns = (int)((g + hs - 1) / hs);
  if (hs <= 0 || (ns > 1) != (part != nullptr))
    return (int)cudaErrorInvalidValue;
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(o) |
                         reinterpret_cast<uintptr_t>(dout)) & 15) == 0;
  const int vec = (dh % 8 == 0) && aligned;
  const long long q_ctas = (sq + bq - 1) / bq * kvh * nhc * b;
  flash_attention_bwd_dq_bf16_mma<DP>
      <<<(unsigned)q_ctas, TC_THREADS, S::DQ_SMEM, stream>>>(
          q, k, v, o, dout, lse, dq, drow, (int)sq, (int)sk, (int)h,
          (int)kvh, (int)dh, gc, bq, (int)causal, (int)window, (int)prefix,
          scale, cap, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long kv_ctas = (sk + S::BN - 1) / S::BN * kvh * ns * b;
  flash_attention_bwd_dkdv_bf16_mma<DP>
      <<<(unsigned)kv_ctas, TC_THREADS, S::DKDV_SMEM, stream>>>(
          q, k, v, dout, lse, drow, dk, dv, part, (int)b, (int)sq, (int)sk,
          (int)h, (int)kvh, (int)dh, (int)hs, (int)causal, (int)window,
          (int)prefix, scale, cap, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || ns == 1) return (int)err;
  const long long n = b * sk * kvh * dh;
  const long long blocks = (n + 255) / 256 < 132 * 8 ? (n + 255) / 256
                                                      : 132 * 8;
  flash_attention_bwd_sum<<<(unsigned)blocks, 256, 0, stream>>>(
      part, ns, n, dk, dv, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/o/do (b, sq, h, dh), k/v (b, sk, kvh, dh), dq/dk/dv like them: all f32
// (bf16 = 0) or all bf16 (bf16 = 1); lse and drow f32 (b, h, sq), lse the
// forward's.  bf16 only: a dk/dv CTA takes hs of the h / kvh query heads of
// its kv head; where that leaves more than one chunk, part is f32 scratch
// [chunks][2][b·sk·kvh·dh] (else null).  The wrapper checks the shapes,
// h / kvh <= 128, dh <= 256 and refuses causal Sq > Sk.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* drow, void* part, long long b, long long sq, long long sk,
    long long h, long long kvh, long long dh, long long hs,
    long long causal, long long window, long long prefix, long long bf16,
    double scale, double cap, void* stream) {
  if (b == 0 || sq == 0 || sk == 0 || h == 0) return 0;
  if (kvh <= 0 || h % kvh != 0 || dh <= 0 || dh > 256)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float sc = (float)scale, cp = (float)cap;
  const float* ls = (const float*)lse;
  float* dr = (float*)drow;
#define FA_BWD(DP)                                                           \
  return bf16 ? launch_bf16_dp<DP>(                                          \
                    (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,        \
                    (const __nv_bfloat16*)v, (const __nv_bfloat16*)o,        \
                    (const __nv_bfloat16*)dout, ls, (__nv_bfloat16*)dq,      \
                    (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, dr,              \
                    (float*)part, b, sq, sk, h, kvh, dh, hs, causal, window, \
                    prefix, sc, cp, st)                                      \
              : launch_f32_dp<DP>((const float*)q, (const float*)k,          \
                                  (const float*)v, (const float*)o,          \
                                  (const float*)dout, ls, (float*)dq,        \
                                  (float*)dk, (float*)dv, dr, b, sq, sk, h,  \
                                  kvh, dh, causal, window, prefix, sc, cp,   \
                                  st)
  if (dh <= 32) FA_BWD(32);
  if (dh <= 64) FA_BWD(64);
  if (dh <= 128) FA_BWD(128);
  if (dh <= 160) FA_BWD(160);
  FA_BWD(256);
#undef FA_BWD
}
