// SplitNN bottom layer, block-diagonal over M clients: the Hopper port of
// repro/kernels/splitnn_bottom/kernel.py::splitnn_bottom_pallas (K1) and
// ::splitnn_bottom_gather_pallas (K2):
//
//   out[m, i, c] = relu?( sum_k x[m, row(i), k] * w[m, k, c] + b[m, c] )
//
// with row(i) = i (K1), or idx[i] (K2: the training step's minibatch
// gather, fused so the gathered rows never go to device memory).
//
// Bound: bytes.  At a full-HI training step (M=3, B=700, d=11, o=8) the
// call reads ~92 KB of rows and writes ~67 KB, ~0.05 us at 3.35 TB/s,
// against 0.37 MFLOP; the launch itself sets the time.  So the design is
// one launch that does no more than the data needs: the TPU padded d and
// o to 128 lanes, which at these widths (d = 10-11, o = 8 or 1) would
// multiply the work by up to 128*16; here the unpadded tensors come in and
// the kernel masks its own edges.
//
// Design: grid (row tiles, M).  Each block stages w[m] (d*o floats) and
// b[m] in shared memory (cap SMEM_CAP, which the wrapper checks first)
// and, for K2, its tile's indices, in place of the TPU's scalar prefetch.
// Thread t of a tile computes output (row, col) = (t / o, t % o), so the
// stores are coalesced: an FMA chain over k in ascending order, then + b,
// then the ReLU, in the reference's order.  No tensor cores: at depth 11,
// TF32 would only lose digits, and f32 means f32 here.  K1 and K2 share
// bottom_out, so K2 is bitwise K1 on the gathered rows.
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
