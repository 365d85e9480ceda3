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
// Each pair comes in two forms, instances of one template:
//  - K1/K2's f32 form, the TPU kernels' function and the f32 wire's pass;
//  - K1/K2's fp8 wire form, which the fp8 wire runs: the same f32 pass
//    (bitwise the f32 form's output; fp8 is comm-only, the product stays
//    f32), then the epilogue applies the wire rounding of
//    quant.fake_quantize(., "fp8");
//  - K9/K10's operands form, the TPU kernels' function: xq and wq already
//    int8, their pow2 scales sx (K10: already gathered) and sw given;
//  - K9/K10's wire form, which the int8 wire runs: w[m] is quantized by
//    columns in the kernel, K9's f32 rows by rows, K10 gathers the run's
//    int8 slab rows and their scales sx[m, idx[i]]; the epilogue applies
//    the wire rounding of quant.fake_quantize(., "int8").
// A wire form is one launch a call in place of the ~40-100 small launches
// of quantizing around the pass: per client, one pow2 exponent a block of
// WIRE_ROWS rows x o columns, then the encode to the wire dtype and the
// decode; it writes the wire value, and, where the backward asks for it,
// the output before the rounding (its ReLU mask).
//
// Bound: bytes.  At a full-HI training step (M=3, B=700, d=11, o=8) the
// call reads ~92 KB of rows (~23 KB as int8) and writes ~67 KB, ~0.05 us
// at 3.35 TB/s, against 0.37 MFLOP; the launch itself sets the time.  So
// the design is one launch that does no more than the data needs: the TPU
// padded d and o to 128 lanes, which at these widths (d = 10-11, o = 8 or
// 1) would multiply the work by up to 128*16; here the unpadded tensors
// come in and the kernel masks its own edges.
//
// Design: grid (row tiles, M), `rows` rows a tile (the wrapper's choice; a
// wire form's tiles are whole wire blocks).  Each block stages w[m] (d*o
// floats, or d*o bytes for the int8 twins), b[m] and sw[m] in shared
// memory (cap SMEM_CAP, which the wrapper checks first) and, for the
// gathers, its tile's indices, in place of the TPU's scalar prefetch.
// Thread t of a tile computes output (row, col) = (t / o, t % o), so the
// stores are coalesced.  K1/K2: an FMA chain over k in ascending order,
// then + b, then the ReLU, in the reference's order, each row read from
// device memory where its outputs need it (staging the tile's rows in
// shared memory first was slower on the card, PERF.md).  No tensor cores: at
// depth 11, TF32 would only lose digits, and f32 means f32 here.  K9/K10:
// an exact int32 sum over k (any order; d = 11 is no multiple of 4, so no
// __dp4a), then the reference's f32 epilogue, one rounding per operation.
// K1 and K2 share bottom_out, K9 and K10 int8_out, so each gather is
// bitwise its dense twin on the gathered rows, and every form shares the
// pass and the wire epilogue (pass_and_round).  A wire block's ragged last
// rows take the amax of its real rows, as the zero-padded block does, so a
// block's |max| never leaves its CTA: the lanes of a block reduce it in
// their warp (__match_any_sync, __reduce_max_sync) and one shared-memory
// atomicMax a warp and block joins the warps.
//
// Every quantizer step rounds as repro_torch/quant.py does, for bitwise
// equality with the plain compositions: amax / qmax as a true IEEE
// division (__fdiv_rn), the exponent from frexpf (less one at a mantissa
// of exactly 0.5, 0 below FLT_MIN, clamped to +-127), 2^e from the
// exponent bits, x * 2^-e by __fmul_rn, then int8: rintf (half to even, as
// torch.round) and the clamp to +-127; fp8: the clamp to +-448 (NaN
// passes, as torch.clamp) and round-to-nearest-even into e4m3fn with its
// subnormals (cvt.rn.satfinite, which equals torch's cast on every value
// the clamp lets through); the decode's flush of subnormal products; no
// --use_fast_math and no -ftz (build.py).
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr size_t SMEM_CAP = 48 * 1024;   // no opt-in needed below 48 KB
constexpr int WIRE_ROWS = 8;             // repro_torch.quant.QUANT_BLOCK_ROWS

// quant.pow2: 2^e from the exponent bits, exact for e in [-126, 127]
__device__ __forceinline__ float pow2f(int e) {
  return __int_as_float((e + 127) << 23);
}

// The wire dtypes, as quant.py's _QMAX, _encode (of v = x * 2^-e) and the
// cast back of dequantize; NoWire is the forms without a rounding.
struct NoWire {
  static constexpr bool ON = false;
};

struct Int8Wire {
  static constexpr bool ON = true;
  static constexpr float QMAX = 127.f;
  using Q = int8_t;
  __device__ static Q encode(float v) {
    return (int8_t)(int)fminf(fmaxf(rintf(v), -QMAX), QMAX);
  }
  __device__ static float value(Q q) { return (float)q; }
};

struct Fp8Wire {   // float8_e4m3fn, bits in a byte
  static constexpr bool ON = true;
  static constexpr float QMAX = 448.f;
  using Q = uint8_t;
  __device__ static Q encode(float v) {
    v = v < -QMAX ? -QMAX : (v > QMAX ? QMAX : v);
    return (Q)__nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
  }
  __device__ static float value(Q q) {   // exact
    const unsigned em = q & 0x7fu;
    const float mag =
        em == 0x7fu ? __int_as_float(0x7fc00000)
        : em >= 8u  ? __uint_as_float(((em >> 3) + 120u) << 23
                                      | (em & 7u) << 20)
                    : (float)em * 0x1p-9f;        // subnormal: m * 2^-9
    return (q & 0x80u) ? -mag : mag;
  }
};

// quant.pow2_exponent(amax, W): the least e with amax <= qmax * 2^e
template <class W>
__device__ __forceinline__ int pow2_exponent(float amax) {
  const float r = __fdiv_rn(amax, W::QMAX);
  int ex;
  const float mant = frexpf(r, &ex);
  const int e = r >= FLT_MIN ? ex - (mant == 0.5f ? 1 : 0) : 0;  // NaN: 0
  return min(max(e, -127), 127);
}

// quant._encode(x, e, W)
template <class W>
__device__ __forceinline__ typename W::Q encode(float x, int e) {
  return W::encode(__fmul_rn(x, pow2f(-e)));
}

// quant.dequantize: q * 2^e, a subnormal product flushed to a signed zero
template <class W>
__device__ __forceinline__ float decode(typename W::Q q, int e) {
  const float x = __fmul_rn(W::value(q), pow2f(e));
  return fabsf(x) < FLT_MIN ? __fmul_rn(x, 0.f) : x;
}

// K1/K2's output: an FMA chain over k in ascending order, then + b, then
// the ReLU, in the reference's order.
__device__ __forceinline__ float bottom_out(const float* __restrict__ xrow,
                                            const float* ws, const float* bs,
                                            int d, int o, int col,
                                            bool relu) {
  float acc = 0.f;
  for (int k = 0; k < d; ++k) acc = fmaf(xrow[k], ws[k * o + col], acc);
  const float a = acc + bs[col];
  return (relu && a < 0.f) ? 0.f : a;   // NaN passes, as jnp.maximum
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

// The slab row of tile row r: r0 + r, or (GATHER) is[r], -1 outside
// [0, n_rows)
template <bool GATHER>
__device__ __forceinline__ int64_t row_of(const int32_t* is, int64_t r0,
                                          int r, int64_t n_rows) {
  if (!GATHER) return r0 + r;
  const int64_t src = is[r];
  return (src >= 0 && src < n_rows) ? src : -1;
}

// The pass over a tile's rows * o outputs, a thread an output, and the
// wire epilogue.  value(row, r, col) is output (r, col) of tile row r,
// slab row `row` (row_of), before any rounding; a gathered index out of
// range gives NaN, never a fault, and stays out of its wire block's
// |max|.  Without a wire (NoWire) `out` takes the values.  With one, each
// value waits in `pres` (and goes to `pre` unless it is null), its
// block's |max| joins in the warp and one shared atomicMax a warp and
// block (every thread runs the same trips, for the warp intrinsics), and
// after a barrier the rounding writes `out`.  `out` and `pre` point at
// the tile's first output.
template <class W, bool GATHER, class Value>
__device__ __forceinline__ void pass_and_round(
    Value value, const int32_t* is, int64_t r0, int64_t n_rows, int rows,
    int o, float* __restrict__ out, float* __restrict__ pre, float* pres,
    unsigned* amax) {
  const int tid = threadIdx.x;
  const int n_out = rows * o;
  const float nan = __int_as_float(0x7fc00000);
  if constexpr (!W::ON) {
    for (int t = tid; t < n_out; t += blockDim.x) {
      const int r = t / o;
      const int64_t row = row_of<GATHER>(is, r0, r, n_rows);
      out[t] = (GATHER && row < 0) ? nan : value(row, r, t - r * o);
    }
  } else {
    for (int base = 0; base < n_out; base += blockDim.x) {
      const int t = base + tid;
      const bool live = t < n_out;
      const int r = live ? t / o : 0;
      const int64_t row = row_of<GATHER>(is, r0, r, n_rows);
      const bool counted = live && (!GATHER || row >= 0);
      const float a = counted ? value(row, r, t - r * o) : nan;
      if (live) {
        pres[t] = a;
        if (pre) pre[t] = a;
      }
      const int blk = live ? r / WIRE_ROWS : -1;
      const unsigned grp = __match_any_sync(0xffffffffu, blk);
      const unsigned mx = __reduce_max_sync(
          grp, counted ? __float_as_uint(fabsf(a)) : 0u);
      if (live && (tid & 31) == __ffs((int)grp) - 1)
        atomicMax(&amax[blk], mx);
    }
    __syncthreads();
    for (int t = tid; t < n_out; t += blockDim.x) {
      const int r = t / o;
      float a = pres[t];
      if (!GATHER || row_of<GATHER>(is, r0, r, n_rows) >= 0) {
        const int e =
            pow2_exponent<W>(__uint_as_float(amax[r / WIRE_ROWS]));
        a = decode<W>(encode<W>(a, e), e);
      }
      out[t] = a;
    }
  }
}

// A block's shared memory: 4-byte arrays first, then the int8 ones.
struct Smem {
  float* sws;      // o: column scales 2^ew (INT8)
  float* bs;       // o: bias
  float* sxs;      // rows: the tile's row scales (INT8)
  int32_t* is;     // rows: the tile's indices (GATHER)
  unsigned* amax;  // rows / WIRE_ROWS: the wire blocks' |max| bits (WIRE)
  float* pres;     // rows * o: the outputs before the rounding (WIRE)
  float* wfs;      // d * o: w[m] in f32 (f32; INT8 WIRE)
  float* xfs;      // rows * d: the tile's f32 rows (INT8 WIRE, K9)
  int8_t* ws;      // d * o: wq[m] (INT8)
  int8_t* xs;      // rows * d: the tile's int8 rows (INT8 WIRE)
};

__host__ __device__ inline void* take(unsigned char* base, size_t* off,
                                      size_t bytes) {
  void* p = base ? base + *off : nullptr;
  *off += bytes;
  return p;
}

// Carves a block's shared memory from `base` (nullptr: sizes only) and
// returns its bytes; kernel.py::f32_smem_bytes and ::int8_smem_bytes
// count the same.
template <bool INT8, bool GATHER, bool WIRE>
__host__ __device__ size_t carve(unsigned char* base, int d, int o,
                                 int rows, Smem* s) {
  size_t off = 0;
  const size_t f4 = 4;
  s->sws = INT8 ? (float*)take(base, &off, f4 * o) : nullptr;
  s->bs = (float*)take(base, &off, f4 * o);
  s->sxs = INT8 ? (float*)take(base, &off, f4 * rows) : nullptr;
  s->is = GATHER ? (int32_t*)take(base, &off, f4 * rows) : nullptr;
  s->amax = WIRE ? (unsigned*)take(base, &off, f4 * (rows / WIRE_ROWS))
                 : nullptr;
  s->pres = WIRE ? (float*)take(base, &off, f4 * rows * o) : nullptr;
  s->wfs = !INT8 || WIRE ? (float*)take(base, &off, f4 * d * o) : nullptr;
  s->xfs = INT8 && WIRE && !GATHER ? (float*)take(base, &off, f4 * rows * d)
                                    : nullptr;
  s->ws = INT8 ? (int8_t*)take(base, &off, (size_t)d * o) : nullptr;
  s->xs = INT8 && WIRE ? (int8_t*)take(base, &off, (size_t)rows * d)
                       : nullptr;
  return off;
}

// ------------------------------------------- K1/K2: the f32 pass (W: the
// f32 form NoWire, or the fp8 wire form Fp8Wire)
template <bool GATHER, class W>
__global__ void __launch_bounds__(THREADS) bottom_kernel(
    const int32_t* __restrict__ idx, const float* __restrict__ x,
    const float* __restrict__ w, const float* __restrict__ b,
    float* __restrict__ out, float* __restrict__ pre, int64_t n_rows,
    int64_t bsz, int d, int o, int rows_per_block, bool relu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem s;
  carve<false, GATHER, W::ON>(smem_raw, d, o, rows_per_block, &s);

  const int m = blockIdx.y;
  const int tid = threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int rows = (int)min((int64_t)rows_per_block, bsz - r0);
  const float* xm = x + (int64_t)m * n_rows * d;

  for (int t = tid; t < d * o; t += blockDim.x)
    s.wfs[t] = w[(int64_t)m * d * o + t];
  for (int t = tid; t < o; t += blockDim.x) s.bs[t] = b[(int64_t)m * o + t];
  if (GATHER)
    for (int t = tid; t < rows; t += blockDim.x) s.is[t] = idx[r0 + t];
  if (W::ON)
    for (int t = tid; t < rows_per_block / WIRE_ROWS; t += blockDim.x)
      s.amax[t] = 0u;
  __syncthreads();

  const int64_t obase = ((int64_t)m * bsz + r0) * o;
  pass_and_round<W, GATHER>(
      [&](int64_t row, int, int col) {
        return bottom_out(xm + row * d, s.wfs, s.bs, d, o, col, relu);
      },
      s.is, r0, n_rows, rows, o, out + obase, pre ? pre + obase : nullptr,
      s.pres, s.amax);
}

template <bool GATHER, class W>
int launch(const void* idx, const void* x, const void* w, const void* b,
           void* out, void* pre, long long m, long long n_rows,
           long long bsz, long long d, long long o, long long relu,
           long long rows, void* stream) {
  if (m == 0 || bsz == 0 || o == 0) return 0;
  if (rows <= 0 || (W::ON && rows % WIRE_ROWS != 0))
    return (int)cudaErrorInvalidValue;
  Smem s;
  const size_t smem = carve<false, GATHER, W::ON>(nullptr, (int)d, (int)o,
                                                  (int)rows, &s);
  if (smem > SMEM_CAP) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((bsz + rows - 1) / rows), (unsigned)m);
  bottom_kernel<GATHER, W><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const float*)x, (const float*)w, (const float*)b,
      (float*)out, (float*)pre, n_rows, bsz, (int)d, (int)o, (int)rows,
      relu != 0);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ K9/K10: the int8 pass

// GATHER: rows idx[i] of the (m, n_rows, d) int8 slab xv (K10), else rows
// i of xv (K9: int8 in the operands form, f32 in the wire form).  The
// operands form takes wv = wq (int8), sw, and sx (m, bsz) per output row;
// the wire form takes the f32 wv = w, no sw, and for K10 the slab's row
// scales sx (m, n_rows).
//
// The wire form reads device memory in one round trip: stage 1 issues
// every load of w[m] and of K9's tile (coalesced; K10 its indices), stage
// 2 quantizes from shared memory (K10 gathers its int8 rows and scales
// meanwhile), then the pass from shared memory and the rounding.
template <bool GATHER, bool WIRE>
__global__ void __launch_bounds__(THREADS) bottom_int8_kernel(
    const int32_t* __restrict__ idx, const void* __restrict__ xv,
    const float* __restrict__ sx, const void* __restrict__ wv,
    const float* __restrict__ sw, const float* __restrict__ b,
    float* __restrict__ out, float* __restrict__ pre, int64_t n_rows,
    int64_t bsz, int d, int o, int rows_per_block, bool relu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem s;
  carve<true, GATHER, WIRE>(smem_raw, d, o, rows_per_block, &s);

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
      const int e = pow2_exponent<Int8Wire>(amax);
      int8_t* q = col ? s.ws + u : s.xs + (u - o) * d;
      for (int k = 0; k < d; ++k)
        q[k * step] = encode<Int8Wire>(v[k * step], e);
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

  // 3. the pass (from shared memory in the wire form) and the rounding
  using W = typename std::conditional<WIRE, Int8Wire, NoWire>::type;
  const int64_t obase = ((int64_t)m * bsz + r0) * o;
  pass_and_round<W, GATHER>(
      [&](int64_t row, int r, int col) {
        const int8_t* xrow = WIRE ? s.xs + r * d : xm + row * d;
        return int8_out(xrow, s.sxs[r], s.ws, s.sws, s.bs, d, o, col, relu);
      },
      s.is, r0, n_rows, rows, o, out + obase, pre ? pre + obase : nullptr,
      s.pres, s.amax);
}

template <bool GATHER, bool WIRE>
int launch_int8(const void* idx, const void* x, const void* sx,
                const void* w, const void* sw, const void* b, void* out,
                void* pre, long long m, long long n_rows, long long bsz,
                long long d, long long o, long long relu, long long rows,
                void* stream) {
  if (m == 0 || bsz == 0 || o == 0) return 0;
  if (rows <= 0 || rows % WIRE_ROWS != 0) return (int)cudaErrorInvalidValue;
  Smem s;
  const size_t smem = carve<true, GATHER, WIRE>(nullptr, (int)d, (int)o,
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

// K1. x (m, n, d), w (m, d, o), b (m, o) f32 -> out (m, n, o) f32; `rows`
// a CTA.
extern "C" int splitnn_bottom_launch(const void* x, const void* w,
                                     const void* b, void* out, long long m,
                                     long long n, long long d, long long o,
                                     long long relu, long long rows,
                                     void* stream) {
  return launch<false, NoWire>(nullptr, x, w, b, out, nullptr, m, n, n, d,
                               o, relu, rows, stream);
}

// K2. idx (bsz,) i32, x (m, n, d), w (m, d, o), b (m, o) f32
// -> out (m, bsz, o) f32 over the rows x[:, idx].
extern "C" int splitnn_bottom_gather_launch(
    const void* idx, const void* x, const void* w, const void* b, void* out,
    long long m, long long n, long long bsz, long long d, long long o,
    long long relu, long long rows, void* stream) {
  return launch<true, NoWire>(idx, x, w, b, out, nullptr, m, n, bsz, d, o,
                              relu, rows, stream);
}

// K1, the fp8 wire form: as K1 -> out (m, n, o) f32, the wire value, and,
// unless pre is null, pre (m, n, o) f32, K1's output before the rounding;
// `rows` a CTA, a multiple of WIRE_ROWS.
extern "C" int splitnn_bottom_fp8_launch(const void* x, const void* w,
                                         const void* b, void* out, void* pre,
                                         long long m, long long n,
                                         long long d, long long o,
                                         long long relu, long long rows,
                                         void* stream) {
  return launch<false, Fp8Wire>(nullptr, x, w, b, out, pre, m, n, n, d, o,
                                relu, rows, stream);
}

// K2, the fp8 wire form: as K2 -> out and pre as the fp8 wire K1, over
// the rows x[:, idx].
extern "C" int splitnn_bottom_fp8_gather_launch(
    const void* idx, const void* x, const void* w, const void* b, void* out,
    void* pre, long long m, long long n, long long bsz, long long d,
    long long o, long long relu, long long rows, void* stream) {
  return launch<true, Fp8Wire>(idx, x, w, b, out, pre, m, n, bsz, d, o,
                               relu, rows, stream);
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
