// SplitNN bottom layer, block-diagonal over M clients: the Hopper port of
// repro/kernels/splitnn_bottom/kernel.py::splitnn_bottom_pallas (K1),
// ::splitnn_bottom_gather_pallas (K2) and their int8 twins
// ::splitnn_bottom_int8_pallas (K9) and ::splitnn_bottom_int8_gather_pallas
// (K10):
//
//   K1/K2:  out[m, i, c] = relu?( sum_k x[m, row(i), k] * w[m, k, c]
//                                 + b[m, c] )
//   K9/K10: out[m, i, c] = relu?( i32(sum_k xq[m, row(i), k] * wq[m, k, c])
//                                 * (sx[m, i] * sw[m, c]) + b[m, c] )
//
// with row(i) = i (K1, K9), or idx[i] (K2, K10: the training step's
// minibatch gather, fused so the gathered rows never go to device memory;
// K10's per-row scales sx arrive already gathered, as in the reference).
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
// K2 share bottom_out, K9 and K10 bottom_int8_out, so each gather is
// bitwise its dense twin on the gathered rows.
#include <cuda_runtime.h>
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

// K9/K10's output: the exact int32 accumulator, then the reference's
// epilogue `acc.float() * (sx * sw) + b`.  __fmul_rn/__fadd_rn are never
// contracted: nvcc fuses a plain x*y+z into an FMA by default, which would
// round once where the reference rounds twice.
__device__ __forceinline__ float bottom_int8_out(
    const int8_t* __restrict__ xrow, float sxi, const int8_t* ws,
    const float* sws, const float* bs, int d, int o, int col, bool relu) {
  int acc = 0;
  for (int k = 0; k < d; ++k) acc += (int)xrow[k] * (int)ws[k * o + col];
  const float s = __fmul_rn(sxi, sws[col]);
  const float a = __fadd_rn(__fmul_rn(__int2float_rn(acc), s), bs[col]);
  return (relu && a < 0.f) ? 0.f : a;   // NaN passes, as jnp.maximum
}

template <bool GATHER>
__global__ void bottom_int8_kernel(const int32_t* __restrict__ idx,
                                   const int8_t* __restrict__ xq,
                                   const float* __restrict__ sx,
                                   const int8_t* __restrict__ wq,
                                   const float* __restrict__ sw,
                                   const float* __restrict__ b,
                                   float* __restrict__ out, int64_t n_rows,
                                   int64_t bsz, int d, int o,
                                   int rows_per_block, bool relu) {
  extern __shared__ float smem[];
  float* sws = smem;                                   // o
  float* bs = sws + o;                                 // o
  int32_t* is = reinterpret_cast<int32_t*>(bs + o);    // rows (K10)
  int8_t* ws = reinterpret_cast<int8_t*>(is + (GATHER ? rows_per_block : 0));

  const int m = blockIdx.y;
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int rows = (int)min((int64_t)rows_per_block, bsz - r0);

  for (int t = threadIdx.x; t < d * o; t += blockDim.x)
    ws[t] = wq[(int64_t)m * d * o + t];
  for (int t = threadIdx.x; t < o; t += blockDim.x) {
    sws[t] = sw[(int64_t)m * o + t];
    bs[t] = b[(int64_t)m * o + t];
  }
  if (GATHER)
    for (int t = threadIdx.x; t < rows; t += blockDim.x) is[t] = idx[r0 + t];
  __syncthreads();

  const int8_t* xm = xq + (int64_t)m * n_rows * d;
  const float* sxm = sx + (int64_t)m * bsz + r0;
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
    om[t] = bottom_int8_out(xm + src * d, sxm[r], ws, sws, bs, d, o, col,
                            relu);
  }
}

template <bool GATHER>
int launch_int8(const void* idx, const void* xq, const void* sx,
                const void* wq, const void* sw, const void* b, void* out,
                long long m, long long n_rows, long long bsz, long long d,
                long long o, long long relu, void* stream) {
  if (m == 0 || bsz == 0 || o == 0) return 0;
  const int rpb = o >= THREADS ? 1 : (int)(THREADS / o);
  const size_t smem = (size_t)(2 * o + (GATHER ? rpb : 0)) * 4 +
                      (size_t)(d * o);
  if (smem > SMEM_CAP) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((bsz + rpb - 1) / rpb), (unsigned)m);
  bottom_int8_kernel<GATHER><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const int8_t*)xq, (const float*)sx,
      (const int8_t*)wq, (const float*)sw, (const float*)b, (float*)out,
      n_rows, bsz, (int)d, (int)o, rpb, relu != 0);
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

// K9. xq (m, n, d) i8, sx (m, n) f32, wq (m, d, o) i8, sw (m, o) f32,
// b (m, o) f32 -> out (m, n, o) f32.
extern "C" int splitnn_bottom_int8_launch(const void* xq, const void* sx,
                                          const void* wq, const void* sw,
                                          const void* b, void* out,
                                          long long m, long long n,
                                          long long d, long long o,
                                          long long relu, void* stream) {
  return launch_int8<false>(nullptr, xq, sx, wq, sw, b, out, m, n, n, d, o,
                            relu, stream);
}

// K10. idx (bsz,) i32, xq (m, n, d) i8, sx (m, bsz) f32 (the gathered rows'
// scales), wq, sw, b as K9 -> out (m, bsz, o) f32 over the rows xq[:, idx].
extern "C" int splitnn_bottom_int8_gather_launch(
    const void* idx, const void* xq, const void* sx, const void* wq,
    const void* sw, const void* b, void* out, long long m, long long n,
    long long bsz, long long d, long long o, long long relu, void* stream) {
  return launch_int8<true>(idx, xq, sx, wq, sw, b, out, m, n, bsz, d, o,
                           relu, stream);
}
