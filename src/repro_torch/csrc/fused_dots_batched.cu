// fused_dots_batched: the 9 inner products of p-BiCGSafe's single reduction
// phase for m right-hand sides at once, in one pass over five (n, m)
// row-major blocks (s, y, r, t_prev, r0*):
//
//   out[k, j] = sum_i a_k[i, j] * b_k[i, j],   out (9, m),
//   (a_k, b_k) = (s,s) (y,y) (s,y) (s,r) (y,r) (rs,r) (rs,s) (rs,t) (r,r)
//
// Replaces src/repro/kernels/fused_dots.py:fused_dots_batched_pallas.
//
// What bounds it on an H100: bytes.  It reads 5 blocks once (40 * m bytes
// per row in fp64) and does 18 flops per element, far below the card's
// flop-per-byte balance.
//
// Design.  The TPU kernel walks a sequential (column, row-block) grid on one
// core and carries each column's sum in its output block.  CUDA blocks run
// in parallel and in no order, so, as in fused_dots.cu, the sum is taken in
// two kernels with a fixed grid and no atomics; the result repeats bitwise.
//   1. partial: a block of 256 threads covers a tile of W = min(m, 256)
//      neighbouring columns (blockIdx.y picks the tile) and R = 256 / W rows
//      per pass; thread t owns column t % W and row t / W of each group of
//      R rows.  The warp's loads are then contiguous in the row-major block,
//      and each thread's 9 register accumulators belong to one column.  The
//      block adds the R threads of each column in shared memory, by a
//      halving tree in a fixed order, and writes (nblocks, 9, m) partials.
//   2. final: one block per output (9 * m of them) adds its nblocks
//      partials, strided over 256 threads, then a fixed-order block sum.
// Accumulation is in the input type (double or float), which is
// promote(dtype, float32) for the two types the wrapper admits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDots = 9;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dots_batched_partial(const T* __restrict__ s, const T* __restrict__ y,
                     const T* __restrict__ r, const T* __restrict__ t,
                     const T* __restrict__ rs, int64_t n, int m, int width,
                     T* __restrict__ partials) {
  __shared__ T red[kDots][kThreads];
  const int rows = kThreads / width;          // R rows per pass
  const int lane_col = threadIdx.x % width;
  const int lane_row = threadIdx.x / width;   // == rows for idle threads
  const int col = blockIdx.y * width + lane_col;
  const bool live = lane_row < rows && col < m;

  T acc[kDots];
#pragma unroll
  for (int k = 0; k < kDots; ++k) acc[k] = T(0);
  if (live) {
    const int64_t step = (int64_t)gridDim.x * rows;
    for (int64_t row = (int64_t)blockIdx.x * rows + lane_row; row < n;
         row += step) {
      const int64_t i = row * m + col;
      const T sv = s[i], yv = y[i], rv = r[i], tv = t[i], qv = rs[i];
      acc[0] += sv * sv;
      acc[1] += yv * yv;
      acc[2] += sv * yv;
      acc[3] += sv * rv;
      acc[4] += yv * rv;
      acc[5] += qv * rv;
      acc[6] += qv * sv;
      acc[7] += qv * tv;
      acc[8] += rv * rv;
    }
  }
#pragma unroll
  for (int k = 0; k < kDots; ++k) red[k][threadIdx.x] = acc[k];
  __syncthreads();
  // halving tree over the R rows of each column: every block and every
  // launch adds in the same order
  for (int h = rows; h > 1;) {
    const int half = (h + 1) / 2;
    if (lane_row < h - half) {
#pragma unroll
      for (int k = 0; k < kDots; ++k)
        red[k][threadIdx.x] += red[k][threadIdx.x + half * width];
    }
    __syncthreads();
    h = half;
  }
  if (lane_row == 0 && col < m) {
#pragma unroll
    for (int k = 0; k < kDots; ++k)
      partials[((int64_t)blockIdx.x * kDots + k) * m + col] = red[k][threadIdx.x];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dots_batched_final(const T* __restrict__ partials, int nblocks, int outputs,
                   T* __restrict__ out) {
  __shared__ T red[kWarps];
  const int o = blockIdx.x;                   // output k * m + j
  T acc = T(0);
  for (int b = threadIdx.x; b < nblocks; b += kThreads)
    acc += partials[(int64_t)b * outputs + o];
  acc = warp_sum(acc);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = warp_sum(lane < kWarps ? red[lane] : T(0));
    if (lane == 0) out[o] = acc;
  }
}

template <typename T>
int launch(const void* s, const void* y, const void* r, const void* t,
           const void* rs, int64_t n, int m, int width, void* partials,
           int nblocks, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (m + width - 1) / width;
  dots_batched_partial<T><<<dim3(nblocks, tiles), kThreads, 0, st>>>(
      static_cast<const T*>(s), static_cast<const T*>(y),
      static_cast<const T*>(r), static_cast<const T*>(t),
      static_cast<const T*>(rs), n, m, width, static_cast<T*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dots_batched_final<T><<<kDots * m, kThreads, 0, st>>>(
      static_cast<const T*>(partials), nblocks, kDots * m,
      static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// s, y, r, t, rs: (n, m) row-major; width = min(m, 256) columns per tile;
// partials: nblocks * 9 * m scratch; out: (9, m).  Returns the cudaError_t
// of the two launches (0 on success).
extern "C" int repro_fused_dots_batched_f64(
    const void* s, const void* y, const void* r, const void* t,
    const void* rs, int64_t n, int m, int width, void* partials, int nblocks,
    void* out, void* stream) {
  return launch<double>(s, y, r, t, rs, n, m, width, partials, nblocks, out,
                        stream);
}

extern "C" int repro_fused_dots_batched_f32(
    const void* s, const void* y, const void* r, const void* t,
    const void* rs, int64_t n, int m, int width, void* partials, int nblocks,
    void* out, void* stream) {
  return launch<float>(s, y, r, t, rs, n, m, width, partials, nblocks, out,
                       stream);
}
