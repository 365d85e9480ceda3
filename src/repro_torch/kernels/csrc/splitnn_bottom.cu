// SplitNN bottom layer, block-diagonal over M clients: the Hopper port of
// repro/kernels/splitnn_bottom/kernel.py::splitnn_bottom_pallas (K1),
// ::splitnn_bottom_gather_pallas (K2) and their int8 twins
// ::splitnn_bottom_int8_pallas (K9) and ::splitnn_bottom_int8_gather_pallas
// (K10):
//
//   K1/K2:  out[m, i, c] = relu?( sum_k x[m, row(i), k] * w[m, k, c]
//                                 + b[m, c] )
//   K9/K10: out[m, i, c] = relu?( i32(sum_k xq[m, row(i), k] * wq[m, k, c])
//                                 * (sx[m, row(i)] * sw[m, c]) + b[m, c] )
//
// with row(i) = i (K1, K9), or idx[i] (K2, K10: the training step's
// minibatch gather, fused so the gathered rows never go to device memory).
//
// K9/K10 come in two forms, instances of one template:
//  - the operands form, the TPU kernels' function: xq and wq already int8,
//    their pow2 scales sx (K10: already gathered) and sw given;
//  - the wire form, which the quantized wire runs (one launch a call in
//    place of the ~70-100 small launches of quantizing around the pass):
//    w[m] is quantized by columns in the kernel, K9's f32 rows by rows,
//    K10 gathers the run's int8 slab rows and their scales sx[m, idx[i]];
//    the epilogue applies the wire rounding of quant.fake_quantize(., "int8")
//    (per client, one pow2 exponent a block of WIRE_ROWS rows x o columns)
//    and writes the wire value, and, where the backward asks for it, the
//    output before the rounding (its ReLU mask).
//
// Bound: bytes.  At a full-HI training step (M=3, B=700, d=11, o=8) the
// call reads ~92 KB of rows (~23 KB as int8) and writes ~67 KB, ~0.05 us
// at 3.35 TB/s, against 0.37 MFLOP; the launch itself sets the time.  So
// the design is one launch that does no more than the data needs: the TPU
// padded d and o to 128 lanes, which at these widths (d = 10-11, o = 8 or
// 1) would multiply the work by up to 128*16; here the unpadded tensors
// come in and the kernel masks its own edges.
//
// Design: grid (row tiles, M).  Each block stages w[m] (d*o floats, or d*o
// bytes for the int8 twins), b[m] and sw[m] in shared memory (cap
// SMEM_CAP, which the wrapper checks first) and, for the gathers, its
// tile's indices, in place of the TPU's scalar prefetch.  Thread t of a
// tile computes output (row, col) = (t / o, t % o), so the stores are
// coalesced.  K1/K2: an FMA chain over k in ascending order, then + b,
// then the ReLU, in the reference's order.  No tensor cores: at depth 11,
// TF32 would only lose digits, and f32 means f32 here.  K9/K10: an exact
// int32 sum over k (any order; d = 11 is no multiple of 4, so no __dp4a),
// then the reference's f32 epilogue, one rounding per operation.  K1 and
// K2 share bottom_out, K9 and K10 int8_out, so each gather is bitwise its
// dense twin on the gathered rows.  The int8 tiles are whole wire blocks
// (the wrapper's rows a CTA is a multiple of WIRE_ROWS, and the ragged
// last block of a batch takes the amax of its real rows, as the zero-padded
// block does), so a block's |max| never leaves its CTA: the lanes of a
// block reduce it in their warp (__match_any_sync, __reduce_max_sync) and
// one shared-memory atomicMax a warp and block joins the warps.
//
// Every quantizer step rounds as repro_torch/quant.py does, for bitwise
// equality with the plain composition quantize_rows -> int8 pass ->
// fake_quantize: amax / 127 as a true IEEE division (__fdiv_rn), the
// exponent from frexpf (less one at a mantissa of exactly 0.5, 0 below
// FLT_MIN, clamped to +-127), 2^e from the exponent bits, rintf (half to
// even, as torch.round), the clamp to +-127, the decode's flush of
// subnormal products; no --use_fast_math and no -ftz (build.py).
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr size_t SMEM_CAP = 48 * 1024;   // no opt-in needed below 48 KB

__device__ __forceinline__ float bottom_out(const float* __restrict__ xrow,
                                            const float* ws, const float* bs,
                                            int d, int o, int col,
                                            bool relu) {
  float acc = 0.f;
  for (int k = 0; k < d; ++k) acc = fmaf(xrow[k], ws[k * o + col], acc);
  const float a = acc + bs[col];
  return (relu && a < 0.f) ? 0.f : a;   // NaN passes, as jnp.maximum
}

template <bool GATHER>
__global__ void bottom_kernel(const int32_t* __restrict__ idx,
                              const float* __restrict__ x,
                              const float* __restrict__ w,
                              const float* __restrict__ b,
                              float* __restrict__ out, int64_t n_rows,
                              int64_t bsz, int d, int o, int rows_per_block,
                              bool relu) {
  extern __shared__ float smem[];
  float* ws = smem;                                  // d * o
  float* bs = ws + d * o;                            // o
  int32_t* is = reinterpret_cast<int32_t*>(bs + o);  // rows_per_block (K2)

  const int m = blockIdx.y;
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int rows = (int)min((int64_t)rows_per_block, bsz - r0);

  for (int t = threadIdx.x; t < d * o; t += blockDim.x)
    ws[t] = w[(int64_t)m * d * o + t];
  for (int t = threadIdx.x; t < o; t += blockDim.x)
    bs[t] = b[(int64_t)m * o + t];
  if (GATHER)
    for (int t = threadIdx.x; t < rows; t += blockDim.x) is[t] = idx[r0 + t];
  __syncthreads();

  const float* xm = x + (int64_t)m * n_rows * d;
  float* om = out + ((int64_t)m * bsz + r0) * o;
  for (int t = threadIdx.x; t < rows * o; t += blockDim.x) {
    const int r = t / o;
    const int col = t - r * o;
    int64_t src = r0 + r;
    if (GATHER) {
      src = is[r];
      if (src < 0 || src >= n_rows) {   // out of range: NaN, never a fault
        om[t] = __int_as_float(0x7fc00000);
        continue;
      }
    }
    om[t] = bottom_out(xm + src * d, ws, bs, d, o, col, relu);
  }
}

template <bool GATHER>
int launch(const void* idx, const void* x, const void* w, const void* b,
           void* out, long long m, long long n_rows, long long bsz,
           long long d, long long o, long long relu, void* stream) {
  if (m == 0 || bsz == 0 || o == 0) return 0;
  const int rpb = o >= THREADS ? 1 : (int)(THREADS / o);
  const size_t smem = (size_t)(d * o + o) * sizeof(float) +
                      (GATHER ? rpb * sizeof(int32_t) : 0);
  if (smem > SMEM_CAP) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((bsz + rpb - 1) / rpb), (unsigned)m);
  bottom_kernel<GATHER><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const float*)x, (const float*)w, (const float*)b,
      (float*)out, n_rows, bsz, (int)d, (int)o, rpb, relu != 0);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ K9/K10: the int8 pass

constexpr int WIRE_ROWS = 8;     // repro_torch.quant.QUANT_BLOCK_ROWS
constexpr float QMAX = 127.f;

// quant.pow2: 2^e from the exponent bits, exact for e in [-126, 127]
__device__ __forceinline__ float pow2f(int e) {
  return __int_as_float((e + 127) << 23);
}

// quant.pow2_exponent(amax, "int8"): the least e with amax <= 127 * 2^e
__device__ __forceinline__ int pow2_exponent(float amax) {
  const float r = __fdiv_rn(amax, QMAX);
  int ex;
  const float mant = frexpf(r, &ex);
  const int e = r >= FLT_MIN ? ex - (mant == 0.5f ? 1 : 0) : 0;  // NaN: 0
  return min(max(e, -127), 127);
}

// quant._encode(x, e, "int8")
__device__ __forceinline__ int8_t encode(float x, int e) {
  const float v = rintf(__fmul_rn(x, pow2f(-e)));
  return (int8_t)(int)fminf(fmaxf(v, -QMAX), QMAX);
}

// quant.dequantize: q * 2^e, a subnormal product flushed to a signed zero
__device__ __forceinline__ float decode(int8_t q, int e) {
  const float x = __fmul_rn((float)q, pow2f(e));
  return fabsf(x) < FLT_MIN ? __fmul_rn(x, 0.f) : x;
}

// K9/K10's output: the exact int32 accumulator, then the reference's
// epilogue `acc.float() * (sx * sw) + b`.  __fmul_rn/__fadd_rn are never
// contracted: nvcc fuses a plain x*y+z into an FMA by default, which would
// round once where the reference rounds twice.
__device__ __forceinline__ float int8_out(const int8_t* xrow, float sxi,
                                          const int8_t* ws, const float* sws,
                                          const float* bs, int d, int o,
                                          int col, bool relu) {
  int acc = 0;
  for (int k = 0; k < d; ++k) acc += (int)xrow[k] * (int)ws[k * o + col];
  const float s = __fmul_rn(sxi, sws[col]);
  const float a = __fadd_rn(__fmul_rn(__int2float_rn(acc), s), bs[col]);
  return (relu && a < 0.f) ? 0.f : a;   // NaN passes, as jnp.maximum
}

// A block's shared memory: 4-byte arrays first, then the int8 ones.
struct Int8Smem {
  float* sws;      // o: column scales 2^ew
  float* bs;       // o: bias
  float* sxs;      // rows: the tile's row scales
  int32_t* is;     // rows: the tile's indices (GATHER)
  unsigned* amax;  // rows / WIRE_ROWS: the wire blocks' |max| bits (WIRE)
  float* pres;     // rows * o: the outputs before the rounding (WIRE)
  float* wfs;      // d * o: w[m] in f32 (WIRE)
  float* xfs;      // rows * d: the tile's f32 rows (WIRE, K9)
  int8_t* ws;      // d * o: wq[m]
  int8_t* xs;      // rows * d: the tile's int8 rows (WIRE)
};

__host__ __device__ inline void* take(unsigned char* base, size_t* off,
                                      size_t bytes) {
  void* p = base ? base + *off : nullptr;
  *off += bytes;
  return p;
}

// Carves a block's shared memory from `base` (nullptr: sizes only) and
// returns its bytes; kernel.py::int8_smem_bytes counts the same.
template <bool GATHER, bool WIRE>
__host__ __device__ size_t carve(unsigned char* base, int d, int o,
                                 int rows, Int8Smem* s) {
  size_t off = 0;
  const size_t f4 = 4;
  s->sws = (float*)take(base, &off, f4 * o);
  s->bs = (float*)take(base, &off, f4 * o);
  s->sxs = (float*)take(base, &off, f4 * rows);
  s->is = GATHER ? (int32_t*)take(base, &off, f4 * rows) : nullptr;
  s->amax = WIRE ? (unsigned*)take(base, &off, f4 * (rows / WIRE_ROWS))
                 : nullptr;
  s->pres = WIRE ? (float*)take(base, &off, f4 * rows * o) : nullptr;
  s->wfs = WIRE ? (float*)take(base, &off, f4 * d * o) : nullptr;
  s->xfs = WIRE && !GATHER ? (float*)take(base, &off, f4 * rows * d)
                           : nullptr;
  s->ws = (int8_t*)take(base, &off, (size_t)d * o);
  s->xs = WIRE ? (int8_t*)take(base, &off, (size_t)rows * d) : nullptr;
  return off;
}

// GATHER: rows idx[i] of the (m, n_rows, d) int8 slab xv (K10), else rows
// i of xv (K9: int8 in the operands form, f32 in the wire form).  The
// operands form takes wv = wq (int8), sw, and sx (m, bsz) per output row;
// the wire form takes the f32 wv = w, no sw, and for K10 the slab's row
// scales sx (m, n_rows).  Out-of-range indices write NaN (to out and pre)
// and stay out of their wire block's |max|.
//
// The wire form reads device memory in one round trip: stage 1 issues
// every load of w[m] and of K9's tile (coalesced; K10 its indices), stage
// 2 quantizes from shared memory (K10 gathers its int8 rows and scales
// meanwhile), stage 3 runs the pass from shared memory, stage 4 rounds.
template <bool GATHER, bool WIRE>
__global__ void __launch_bounds__(THREADS) bottom_int8_kernel(
    const int32_t* __restrict__ idx, const void* __restrict__ xv,
    const float* __restrict__ sx, const void* __restrict__ wv,
    const float* __restrict__ sw, const float* __restrict__ b,
    float* __restrict__ out, float* __restrict__ pre, int64_t n_rows,
    int64_t bsz, int d, int o, int rows_per_block, bool relu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Int8Smem s;
  carve<GATHER, WIRE>(smem_raw, d, o, rows_per_block, &s);

  const int m = blockIdx.y;
  const int tid = threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int rows = (int)min((int64_t)rows_per_block, bsz - r0);
  const int8_t* xm = (const int8_t*)xv + (int64_t)m * n_rows * d;

  // 1. loads: bias, indices; the wire form's f32 w[m] and K9's f32 tile,
  //    the operands form's scales and wq[m]
  for (int t = tid; t < o; t += blockDim.x) {
    s.bs[t] = b[(int64_t)m * o + t];
    if (!WIRE) s.sws[t] = sw[(int64_t)m * o + t];
  }
  if (GATHER)
    for (int t = tid; t < rows; t += blockDim.x) s.is[t] = idx[r0 + t];
  if (WIRE) {
    const float* wf = (const float*)wv + (int64_t)m * d * o;
    for (int t = tid; t < d * o; t += blockDim.x) s.wfs[t] = wf[t];
    if (!GATHER) {
      const float* xf = (const float*)xv + ((int64_t)m * n_rows + r0) * d;
      for (int t = tid; t < rows * d; t += blockDim.x) s.xfs[t] = xf[t];
    }
    for (int t = tid; t < rows_per_block / WIRE_ROWS; t += blockDim.x)
      s.amax[t] = 0u;
  } else {
    const int8_t* wq = (const int8_t*)wv + (int64_t)m * d * o;
    for (int t = tid; t < d * o; t += blockDim.x) s.ws[t] = wq[t];
    for (int t = tid; t < rows; t += blockDim.x)
      s.sxs[t] = sx[(int64_t)m * bsz + r0 + t];
  }
  __syncthreads();

  // 2. the wire form's quantizers: a thread a column of w[m] (and, K9, a
  //    thread a row of the tile): |max|, exponent, encode; K10 gathers
  //    its int8 rows and their scales
  if (WIRE) {
    for (int u = tid; u < o + (GATHER ? 0 : rows); u += blockDim.x) {
      const bool col = u < o;
      const float* v = col ? s.wfs + u : s.xfs + (u - o) * d;
      const int step = col ? o : 1;
      float amax = 0.f;
      for (int k = 0; k < d; ++k) amax = fmaxf(amax, fabsf(v[k * step]));
      const int e = pow2_exponent(amax);
      int8_t* q = col ? s.ws + u : s.xs + (u - o) * d;
      for (int k = 0; k < d; ++k) q[k * step] = encode(v[k * step], e);
      float* scale = col ? s.sws + u : s.sxs + (u - o);
      *scale = pow2f(e);
    }
    if (GATHER) {
      for (int t = tid; t < rows * d; t += blockDim.x) {
        const int r = t / d;
        const int64_t src = s.is[r];
        s.xs[t] = (src >= 0 && src < n_rows) ? xm[src * d + (t - r * d)]
                                             : (int8_t)0;
      }
      for (int r = tid; r < rows; r += blockDim.x) {
        const int64_t src = s.is[r];
        s.sxs[r] = (src >= 0 && src < n_rows)
                       ? sx[(int64_t)m * n_rows + src] : 0.f;
      }
    }
    __syncthreads();
  }

  // 3. the pass; the wire form keeps each output and joins its block's
  //    |max|.  Every thread runs the same trips (the warp intrinsics).
  const int64_t obase = ((int64_t)m * bsz + r0) * o;
  const int n_out = rows * o;
  for (int base = 0; base < n_out; base += blockDim.x) {
    const int t = base + tid;
    const bool live = t < n_out;
    const int r = live ? t / o : 0;
    const int col = t - r * o;
    bool counted = live;
    float a = 0.f;
    if (live) {
      const int64_t src = GATHER ? (int64_t)s.is[r] : r0 + r;
      if (GATHER && (src < 0 || src >= n_rows)) {  // NaN, never a fault
        a = __int_as_float(0x7fc00000);
        counted = false;
      } else {
        const int8_t* xrow = WIRE ? s.xs + r * d : xm + src * d;
        a = int8_out(xrow, s.sxs[r], s.ws, s.sws, s.bs, d, o, col, relu);
      }
      if (!WIRE) {
        out[obase + t] = a;
      } else {
        s.pres[t] = a;
        if (pre) pre[obase + t] = a;
      }
    }
    if (WIRE) {
      const int blk = live ? r / WIRE_ROWS : -1;
      const unsigned grp = __match_any_sync(0xffffffffu, blk);
      const unsigned mx = __reduce_max_sync(
          grp, counted ? __float_as_uint(fabsf(a)) : 0u);
      if (live && (tid & 31) == __ffs((int)grp) - 1)
        atomicMax(&s.amax[blk], mx);
    }
  }
  if (!WIRE) return;
  __syncthreads();

  // 4. the wire rounding: encode against the block's exponent, decode
  for (int t = tid; t < n_out; t += blockDim.x) {
    const int r = t / o;
    float a = s.pres[t];
    if (!GATHER || (s.is[r] >= 0 && s.is[r] < n_rows)) {
      const int e = pow2_exponent(__uint_as_float(s.amax[r / WIRE_ROWS]));
      a = decode(encode(a, e), e);
    }
    out[obase + t] = a;
  }
}

template <bool GATHER, bool WIRE>
int launch_int8(const void* idx, const void* x, const void* sx,
                const void* w, const void* sw, const void* b, void* out,
                void* pre, long long m, long long n_rows, long long bsz,
                long long d, long long o, long long relu, long long rows,
                void* stream) {
  if (m == 0 || bsz == 0 || o == 0) return 0;
  if (rows <= 0 || rows % WIRE_ROWS != 0) return (int)cudaErrorInvalidValue;
  Int8Smem s;
  const size_t smem = carve<GATHER, WIRE>(nullptr, (int)d, (int)o,
                                          (int)rows, &s);
  if (smem > SMEM_CAP) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((bsz + rows - 1) / rows), (unsigned)m);
  bottom_int8_kernel<GATHER, WIRE>
      <<<grid, THREADS, smem, (cudaStream_t)stream>>>(
          (const int32_t*)idx, x, (const float*)sx, w, (const float*)sw,
          (const float*)b, (float*)out, (float*)pre, n_rows, bsz, (int)d,
          (int)o, (int)rows, relu != 0);
  return (int)cudaGetLastError();
}

}  // namespace

// K1. x (m, n, d), w (m, d, o), b (m, o) f32 -> out (m, n, o) f32.
extern "C" int splitnn_bottom_launch(const void* x, const void* w,
                                     const void* b, void* out, long long m,
                                     long long n, long long d, long long o,
                                     long long relu, void* stream) {
  return launch<false>(nullptr, x, w, b, out, m, n, n, d, o, relu, stream);
}

// K2. idx (bsz,) i32, x (m, n, d), w (m, d, o), b (m, o) f32
// -> out (m, bsz, o) f32 over the rows x[:, idx].
extern "C" int splitnn_bottom_gather_launch(const void* idx, const void* x,
                                            const void* w, const void* b,
                                            void* out, long long m,
                                            long long n, long long bsz,
                                            long long d, long long o,
                                            long long relu, void* stream) {
  return launch<true>(idx, x, w, b, out, m, n, bsz, d, o, relu, stream);
}

// K9, the operands form.  xq (m, n, d) i8, sx (m, n) f32, wq (m, d, o)
// i8, sw (m, o) f32, b (m, o) f32 -> out (m, n, o) f32; `rows` a CTA.
extern "C" int splitnn_bottom_int8_launch(
    const void* xq, const void* sx, const void* wq, const void* sw,
    const void* b, void* out, long long m, long long n, long long d,
    long long o, long long relu, long long rows, void* stream) {
  return launch_int8<false, false>(nullptr, xq, sx, wq, sw, b, out, nullptr,
                                   m, n, n, d, o, relu, rows, stream);
}

// K10, the operands form.  idx (bsz,) i32, xq (m, n, d) i8, sx (m, bsz)
// f32 (the gathered rows' scales), wq, sw, b as K9 -> out (m, bsz, o) f32
// over the rows xq[:, idx].
extern "C" int splitnn_bottom_int8_gather_launch(
    const void* idx, const void* xq, const void* sx, const void* wq,
    const void* sw, const void* b, void* out, long long m, long long n,
    long long bsz, long long d, long long o, long long relu, long long rows,
    void* stream) {
  return launch_int8<true, false>(idx, xq, sx, wq, sw, b, out, nullptr, m,
                                  n, bsz, d, o, relu, rows, stream);
}

// K9, the wire form.  x (m, n, d), w (m, d, o), b (m, o) f32 -> out
// (m, n, o) f32, the wire value, and, unless pre is null, pre (m, n, o)
// f32, the output before the wire rounding.
extern "C" int splitnn_bottom_int8_wire_launch(
    const void* x, const void* w, const void* b, void* out, void* pre,
    long long m, long long n, long long d, long long o, long long relu,
    long long rows, void* stream) {
  return launch_int8<false, true>(nullptr, x, nullptr, w, nullptr, b, out,
                                  pre, m, n, n, d, o, relu, rows, stream);
}

// K10, the wire form.  idx (bsz,) i32, xq (m, n, d) i8 with its row
// scales sx (m, n) f32 (the whole slab's), w, b f32 -> out and pre as the
// wire K9, over the rows xq[:, idx].
extern "C" int splitnn_bottom_int8_wire_gather_launch(
    const void* idx, const void* xq, const void* sx, const void* w,
    const void* b, void* out, void* pre, long long m, long long n,
    long long bsz, long long d, long long o, long long relu, long long rows,
    void* stream) {
  return launch_int8<true, true>(idx, xq, sx, w, nullptr, b, out, pre, m, n,
                                 bsz, d, o, relu, rows, stream);
}
