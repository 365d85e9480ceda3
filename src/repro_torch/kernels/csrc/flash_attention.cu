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
// All math in f32, one rounding to the output type at the end.  Where the
// caller passes an f32 `lse` (B, H, Sq) (training: K11's backward reads it),
// each instance also writes the row's log-sum-exp in base e, m + log(l) in
// its own arithmetic (the running max and sum it divided by); a null
// pointer writes nothing and leaves the output's bits as they are.
//
// bf16 instance (flash_attention_kernel_bf16_mma): both products on the
// tensor cores, mma.sync.m16n8k16 bf16 -> f32 with ldmatrix operands
// (FlashAttention-2's shape).
//   * CTA: 4 warps, 64 (head, query row) pairs, 16 a warp.  The pairs are
//     the M rows of the score tile, m = r * GC + gi: query row r of the
//     CTA's BQ rows, head gi of the GC = min(G, 64) query heads of one kv
//     head that the CTA holds (BQ = 64 / GC; G need not be a power of two,
//     G = 5 runs 60 of 64 rows; G > 64 splits the heads over CTAs).  So one
//     K/V tile feeds every head of the group, and the G heads of a query row
//     are contiguous in q and out.
//   * K/V tiles of BK keys (64 for Dh <= 128, 32 above) in bf16 shared
//     memory, double-buffered with cp.async (16-byte chunks; zero-filled past
//     Sk and past Dh), so the next tile loads while this one computes; rows
//     padded by 8 elements (16 B) keep ldmatrix's eight row reads on
//     distinct banks without a swizzle.  Q stays in shared memory and is
//     re-read by ldmatrix per tile (no registers spent on it at Dh = 256).
//   * QK^T: one bf16 pass, f32 accumulation (bf16 × bf16 products are exact
//     in f32), then `s * scale` after the product as the reference does
//     (folding scale into q would round q: 1/sqrt(Dh) is not a power of two
//     at Dh = 128 or 160), the softcap, and the element mask only on tiles
//     that cut the diagonal, the window or prefix edge or the key tail
//     (interior tiles take no mask).  p = exp2f((s - m) · log2 e): the
//     difference is taken first, so the product's rounding moves p by
//     ~|s - m|·2^-24 relative, largest where p is smallest; every bf16
//     check row of chip_smoke.py holds with it.
//   * P·V: p is f32, as in the reference (kernel.py:82-89).  It is split
//     into three bf16 pieces, hi = bf16(p), mid = bf16(p - hi), lo =
//     bf16(p - hi - mid), which carry its 24 significand bits whole, and
//     the three products with bf16 v are summed in f32 (lo, mid, then hi,
//     into a per-tile accumulator that is added to the running output with
//     an f32 FMA, so the tensor cores' own additions span one tile only).
//     The output tiles go in groups of NG (8, or 4 at DP 32 and DP >= 160):
//     NG independent accumulator chains a warp, the keys inside.
//     One piece (p rounded to bf16, as SDPA does) or two (~16 bits) fail
//     the bf16 check 2^-7·|plain| + 1e-6 on outputs that come from
//     cancellation (tests/test_torch_flash_attention.py pins one piece).
//     The S accumulator's register layout is the A fragment of P·V, so p
//     never leaves registers.
//   * Tiles outside every row's mask are never loaded (the reference's
//     block-skip test, kernel.py:47-57, on the CTA's rows), and a warp skips
//     the products of a tile outside all of its own rows; causal attention
//     does about half the work.  CTAs start with the last query blocks (the
//     longest causal rows).
//   * Dh is padded to a multiple of 16 with zeros in the products.  DP = 32,
//     64, 128, 160, 256 size the registers and shared memory; where Dh rounds
//     up to DP the loops over Dh are fixed at compile time, else a second
//     instance of that DP runs ceil(Dh / 16) k-steps and output tiles.
//   Budget per instance (64 rows, BK, row stride DP + 8): shared memory
//   (64 + 4·BK)·(DP + 8)·2 B = 25.6 KB (DP 32), 46.1 KB (64), 87.0 KB (128),
//   64.5 KB (160, BK 32), 101.4 KB (256, BK 32), dynamic above 48 KB.
//   Registers a thread: the output accumulator DP/2, the score tile BK/2,
//   the p pieces 3·BK/4, a P·V group 4·NG (128 + 16 + 24 + 16 at DP = 256),
//   capped by the CTAs an SM asked of the register allocator (MIN_CTAS: 4
//   up to DP 64, 3 at 160, else 2, each within what shared memory allows);
//   ptxas's counts and spills for each instance are in PERF.md.
//   Bound: operations on bf16 tensor cores, 1 pass for QK^T and 3 for P·V,
//   4 · 2·B·H·Dh·(visible pairs) at 989 TFLOP/s; q/k/v/out are a few MB.
//
// f32 instance (flash_attention_kernel): the first design, kept for f32
// q/k/v (the f32 model and check rows), where QK^T would need split passes
// too: one CTA per (batch, kv head, tile of BQ query rows), all G query
// heads, one thread per (head, row), G·BQ <= 128 threads; K and V tiles of
// BK = 8192 / (2·DP) keys staged in shared memory as f32, scalar FMAs
// (CUDA cores), softmax updated every 16 keys, the same tile skip; Dh padded
// in registers to DP = 32, 64, 128 or 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr float NEG_INF = -1e30f;

// Visibility of a tile of columns [c0, c1] to query positions [rlo, rhi].
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

// ------------------------------------------------------- f32 (CUDA cores)

constexpr int MAX_ROWS = 128;      // threads (query rows × heads) a CTA
constexpr int TILE_FLOATS = 4096;  // floats in each of the K and V tiles
constexpr int SUB = 16;            // keys per online-softmax update

template <int DP>
__global__ void __launch_bounds__(MAX_ROWS)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, float* __restrict__ lse,
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
  const float* qp = q + (((int64_t)b * sq + row) * h + head) * dh;
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    qr[d] = (active && d < dh) ? qp[d] : 0.f;
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
        kx = k[idx];
        vx = v[idx];
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
          if (!visible(k0 + j, qpos, sk, causal, window, prefix))
            sc = NEG_INF;
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
    float* op = out + (((int64_t)b * sq + row) * h + head) * dh;
#pragma unroll
    for (int d = 0; d < DP; ++d)
      if (d < dh) op[d] = acc[d] / denom;
    if (lse != nullptr)
      lse[((int64_t)b * h + head) * sq + row] = m + logf(denom);
  }
}

int launch_f32(const float* q, const float* k, const float* v, float* out,
               float* lse, long long b, long long sq, long long sk,
               long long h, long long kvh, long long dh, long long causal,
               long long window, long long prefix, float scale, float cap,
               cudaStream_t stream) {
  const int g = (int)(h / kvh);
  if (g > MAX_ROWS) return (int)cudaErrorInvalidValue;
  const int bq = MAX_ROWS / g;
  dim3 grid((unsigned)((sq + bq - 1) / bq), (unsigned)kvh, (unsigned)b);
  const int threads = g * bq;
#define FA_LAUNCH(DP)                                                        \
  flash_attention_kernel<DP><<<grid, threads, 0, stream>>>(                  \
      q, k, v, out, lse, (int)sq, (int)sk, (int)h, (int)kvh, (int)dh, bq,    \
      (int)causal, (int)window, (int)prefix, scale, cap)
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

// --------------------------------------------------- bf16 (tensor cores)

typedef __nv_bfloat16 bf16;

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_ROWS = 16 * TC_WARPS;  // (head, query row) pairs a CTA

template <int DP>
struct TcShape {
  static constexpr int BK = DP <= 128 ? 64 : 32;  // keys a tile
  static constexpr int LD = DP + 8;               // smem row stride (elems)
  static constexpr size_t SMEM = (size_t)(TC_ROWS + 4 * BK) * LD * 2;
  // CTAs an SM asked of the register allocator (shared memory allows them)
  static constexpr int MIN_CTAS = DP <= 64 ? 4 : DP == 160 ? 3 : 2;
};

constexpr float LOG2E = 1.4426950408889634f;

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

template <int DP, bool EXACT>
__global__ void __launch_bounds__(TC_THREADS, TcShape<DP>::MIN_CTAS)
    flash_attention_kernel_bf16_mma(const bf16* __restrict__ q,
                                    const bf16* __restrict__ k,
                                    const bf16* __restrict__ v,
                                    bf16* __restrict__ out,
                                    float* __restrict__ lse, int sq, int sk,
                                    int h, int kvh, int dh, int gc, int bq,
                                    int causal, int window, int prefix,
                                    float scale, float cap, int vec) {
  constexpr int BK = TcShape<DP>::BK;
  constexpr int LD = TcShape<DP>::LD;
  constexpr int NT = BK / 8;   // n8 tiles of a score tile
  constexpr int KS = BK / 16;  // k16 steps of P·V
  constexpr int DT = DP / 8;   // n8 tiles of the output
  constexpr int NG = DP <= 32 ? 4 : DP <= 128 ? 8 : 4;  // tiles a P·V group
  static_assert(DT % NG == 0, "output tiles in whole groups");
  constexpr int CH = DP / 8;   // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [TC_ROWS][LD]
  bf16* k_s = q_s + TC_ROWS * LD;                 // [2][BK][LD]
  bf16* v_s = k_s + 2 * BK * LD;                  // [2][BK][LD]

  const int g = h / kvh;
  const int nhc = (g + gc - 1) / gc;
  const int b = blockIdx.z;
  const int kv = blockIdx.y / nhc;
  const int h0 = (blockIdx.y % nhc) * gc;
  const int gcn = min(gc, g - h0);                // heads of this CTA
  const int q0 = (gridDim.x - 1 - blockIdx.x) * bq;  // longest rows first
  const int nrows = min(bq, sq - q0);
  const int off = sk - sq;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  // k16 steps of QK^T and output tile pairs: a compile-time DP / 16 where
  // Dh rounds up to DP (no guard splits the unrolled loops), else run-time
  const int kq = EXACT ? DP / 16 : (dh + 15) >> 4;
  const bool vec_ok = vec != 0;

  // the CTA's and this warp's query positions, for the tile tests
  const int rlo = off + q0;
  const int rhi = off + q0 + nrows - 1;
  const int wr0 = (warp * 16) / gc;
  const bool warp_busy = wr0 < nrows;
  const int wlo = off + q0 + wr0;
  const int whi = off + q0 + min((warp * 16 + 15) / gc, nrows - 1);
  // this thread's two rows of the score tile (gq and gq + 8)
  const int ma = warp * 16 + gq, mb = ma + 8;
  const int ra = ma / gc, rb = mb / gc;
  const int pos_a = off + q0 + ra, pos_b = off + q0 + rb;

  // Q: the CTA's 64 (row, head) pairs
  for (int c = tid; c < TC_ROWS * CH; c += TC_THREADS) {
    const int m = c / CH, d = (c % CH) * 8;
    const int r = m / gc, gi = m - r * gc;
    const int n = (r < nrows && gi < gcn) ? dh - d : 0;
    const bf16* src =
        q + (((int64_t)b * sq + q0 + r) * h + kv * g + h0 + gi) * dh + d;
    copy8(q_s + m * LD + d, n > 0 ? src : q, q, n, vec_ok);
  }

  auto load_kv = [&](int t, int stage) {
    const int k0 = t * BK;
    bf16* kd = k_s + stage * BK * LD;
    bf16* vd = v_s + stage * BK * LD;
    for (int c = tid; c < BK * CH; c += TC_THREADS) {
      const int j = c / CH, d = (c % CH) * 8;
      const int n = k0 + j < sk ? dh - d : 0;
      const int64_t idx = (((int64_t)b * sk + k0 + j) * kvh + kv) * dh + d;
      copy8(kd + j * LD + d, n > 0 ? k + idx : k, k, n, vec_ok);
      copy8(vd + j * LD + d, n > 0 ? v + idx : v, v, n, vec_ok);
    }
  };
  const int ntiles = (sk + BK - 1) / BK;
  auto next_tile = [&](int t) {
    while (t < ntiles && tile_skipped(t * BK, t * BK + BK - 1, rlo, rhi, sk,
                                      causal, window, prefix))
      ++t;
    return t;
  };

  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;

  int t = next_tile(0);
  if (t < ntiles) load_kv(t, 0);
  cp_async_commit();
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
      // S = Q K^T (f32)
      float s[NT][4];
#pragma unroll
      for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        if (kk < kq) {
          uint32_t a[4];
          ldsm_x4(a, q_s + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                         (lane >> 4) * 8);
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t bk[4];
            ldsm_x4(bk, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
            mma_bf16(s[2 * np], a, bk[0], bk[1]);
            mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
          }
        }
      }
      // scale after the product, softcap, mask on edge tiles; row maxima
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] *= scale;
      if (cap > 0.f) {
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][e] = tanhf(s[i][e] / cap) * cap;
      }
      if (!unmasked) {
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!visible(c0 + i * 8 + tq * 2 + (e & 1), e < 2 ? pos_a : pos_b,
                         sk, causal, window, prefix))
              s[i][e] = NEG_INF;
      }
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        mx_a = fmaxf(mx_a, fmaxf(s[i][0], s[i][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[i][2], s[i][3]));
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      const float corr_a = exp2f((m_a - mx_a) * LOG2E);
      const float corr_b = exp2f((m_b - mx_b) * LOG2E);
      m_a = mx_a;
      m_b = mx_b;
      l_a *= corr_a;
      l_b *= corr_b;
      // p = exp(s - m) in f32, split into three bf16 A fragments
      uint32_t ph[KS][4], pm[KS][4], pl[KS][4];
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        s[i][0] = exp2f((s[i][0] - mx_a) * LOG2E);
        s[i][1] = exp2f((s[i][1] - mx_a) * LOG2E);
        s[i][2] = exp2f((s[i][2] - mx_b) * LOG2E);
        s[i][3] = exp2f((s[i][3] - mx_b) * LOG2E);
        l_a += s[i][0] + s[i][1];
        l_b += s[i][2] + s[i][3];
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        split3(s[2 * kk][0], s[2 * kk][1], ph[kk][0], pm[kk][0], pl[kk][0]);
        split3(s[2 * kk][2], s[2 * kk][3], ph[kk][1], pm[kk][1], pl[kk][1]);
        split3(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[kk][2], pm[kk][2],
               pl[kk][2]);
        split3(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[kk][3], pm[kk][3],
               pl[kk][3]);
      }
      // O = O · corr + P V, NG output tiles at a time: NG independent
      // accumulator chains a warp, each summing one tile's keys
#pragma unroll
      for (int g0 = 0; g0 < DT; g0 += NG) {
        if (EXACT || g0 < 2 * kq) {
          float c[NG][4];
#pragma unroll
          for (int j = 0; j < NG; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
            for (int j = 0; j < NG; j += 2) {
              const int dp = (g0 + j) / 2;  // 16 output columns
              if (EXACT || dp < kq) {
                uint32_t bv[4];
                ldsm_x4_trans(bv, vs + (kk * 16 + (lane & 7) +
                                        ((lane >> 3) & 1) * 8) * LD +
                                      dp * 16 + (lane >> 4) * 8);
                mma_bf16(c[j], pl[kk], bv[0], bv[1]);
                mma_bf16(c[j + 1], pl[kk], bv[2], bv[3]);
                mma_bf16(c[j], pm[kk], bv[0], bv[1]);
                mma_bf16(c[j + 1], pm[kk], bv[2], bv[3]);
                mma_bf16(c[j], ph[kk], bv[0], bv[1]);
                mma_bf16(c[j + 1], ph[kk], bv[2], bv[3]);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < NG; ++j) {
            float* oj = o[g0 + j];
            oj[0] = fmaf(oj[0], corr_a, c[j][0]);
            oj[1] = fmaf(oj[1], corr_a, c[j][1]);
            oj[2] = fmaf(oj[2], corr_b, c[j][2]);
            oj[3] = fmaf(oj[3], corr_b, c[j][3]);
          }
        }
      }
    }
    __syncthreads();
    stage ^= 1;
    t = tn;
  }
  cp_async_wait_0();  // a CTA with no visible tile still has Q in flight

  // the quad's partial row sums, then out = O / max(l, 1e-30)
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = half ? mb : ma;
    const int r = half ? rb : ra;
    const int gi = m - r * gc;
    if (r >= nrows || gi >= gcn) continue;
    const float den = half ? den_b : den_a;
    const int64_t row = ((int64_t)b * sq + q0 + r) * h + kv * g + h0 + gi;
    if (lse != nullptr && tq == 0)
      lse[((int64_t)b * h + kv * g + h0 + gi) * sq + q0 + r] =
          (half ? m_b : m_a) + logf(den);
    bf16* op = out + row * dh;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      const int col = i * 8 + tq * 2;
      if (col < dh) op[col] = __float2bfloat16_rn(o[i][2 * half] / den);
      if (col + 1 < dh)
        op[col + 1] = __float2bfloat16_rn(o[i][2 * half + 1] / den);
    }
  }
}

template <int DP, bool EXACT>
int launch_bf16_dp(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                   float* lse, long long b, long long sq, long long sk,
                   long long h, long long kvh, long long dh, long long causal,
                   long long window, long long prefix, float scale, float cap,
                   cudaStream_t stream) {
  const size_t smem = TcShape<DP>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel_bf16_mma<DP, EXACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int g = (int)(h / kvh);
  const int gc = g < TC_ROWS ? g : TC_ROWS;
  const int bq = TC_ROWS / gc;
  const int nhc = (g + gc - 1) / gc;
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const int vec = (dh % 8 == 0) && aligned;
  dim3 grid((unsigned)((sq + bq - 1) / bq), (unsigned)(kvh * nhc),
            (unsigned)b);
  flash_attention_kernel_bf16_mma<DP, EXACT>
      <<<grid, TC_THREADS, smem, stream>>>(
      q, k, v, out, lse, (int)sq, (int)sk, (int)h, (int)kvh, (int)dh, gc,
      bq, (int)causal, (int)window, (int)prefix, scale, cap, vec);
  return (int)cudaGetLastError();
}

int launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                float* lse, long long b, long long sq, long long sk,
                long long h, long long kvh, long long dh, long long causal,
                long long window, long long prefix, float scale, float cap,
                cudaStream_t stream) {
#define FA_BF16(DP)                                                          \
  return ((dh + 15) & ~15LL) == DP                                           \
             ? launch_bf16_dp<DP, true>(q, k, v, out, lse, b, sq, sk, h,     \
                                        kvh, dh, causal, window, prefix,     \
                                        scale, cap, stream)                  \
             : launch_bf16_dp<DP, false>(q, k, v, out, lse, b, sq, sk, h,    \
                                         kvh, dh, causal, window, prefix,    \
                                         scale, cap, stream)
  if (dh <= 32) FA_BF16(32);
  if (dh <= 64) FA_BF16(64);
  if (dh <= 128) FA_BF16(128);
  if (dh <= 160) FA_BF16(160);
  FA_BF16(256);
#undef FA_BF16
}

}  // namespace

// q (b, sq, h, dh), k/v (b, sk, kvh, dh), out like q; all f32 (bf16 = 0) or
// all bf16 (bf16 = 1).  lse, where not null, is f32 (b, h, sq): the row's
// log-sum-exp of its masked scores in base e, m + log(max(l, 1e-30)).  The
// wrapper checks h % kvh == 0, dh <= 256 and, for f32, h / kvh <= 128.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      long long b,
                                      long long sq, long long sk, long long h,
                                      long long kvh, long long dh,
                                      long long causal, long long window,
                                      long long prefix, long long bf16,
                                      double scale, double cap, void* stream) {
  if (b == 0 || sq == 0 || h == 0) return 0;
  if (kvh <= 0 || h % kvh != 0 || dh <= 0 || dh > 256)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch_bf16((const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                       (const __nv_bfloat16*)v, (__nv_bfloat16*)out,
                       (float*)lse, b, sq, sk, h, kvh, dh, causal, window,
                       prefix, (float)scale, (float)cap, (cudaStream_t)stream);
  return launch_f32((const float*)q, (const float*)k, (const float*)v,
                    (float*)out, (float*)lse, b, sq, sk, h, kvh, dh, causal,
                    window, prefix, (float)scale, (float)cap,
                    (cudaStream_t)stream);
}
