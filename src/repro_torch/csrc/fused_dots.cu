// fused_dots: the 9 inner products of p-BiCGSafe's single reduction phase
// (paper Alg. 3.1 lines 7-8) in one pass over (s, y, r, t_prev, r0*):
//
//   out = [s.s, y.y, s.y, s.r, y.r, rs.r, rs.s, rs.t, r.r]
//
// Replaces src/repro/kernels/fused_dots.py:fused_dots_pallas.
//
// What bounds it on an H100: bytes.  It reads 5 vectors once (40 bytes per
// row in fp64) and does 18 flops per row, far below the card's
// flop-per-byte balance, so its floor is 5*8*n bytes over the HBM rate.
//
// Design.  The TPU kernel walks the row blocks in order on one core and
// carries the sum in its output block.  Blocks on the GPU run in parallel
// and in no order, so the sum is taken in two kernels:
//   1. fused_dots_partial: a fixed number of blocks run a grid-stride loop
//      over the rows; each thread keeps its 9 sums in registers (double for
//      fp64, float for fp32), then the block reduces them with warp
//      shuffles and shared memory and writes one row of (nblocks, 9)
//      partials.  Each element of the five vectors is read exactly once.
//   2. fused_dots_final: one block sums the partials in a fixed order.
// No atomics: for a given n the grid and every summation order are fixed,
// so the result repeats bitwise from run to run (an iteration count near
// the tolerance moves by 1-2 when the order changes).
// Inputs are read with plain coalesced loads; vector loads and TMA are
// left for later work.

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

// Reduce the block's kDots per-thread sums; thread 0 ends with the totals
// in acc.  Every block reduces in the same order.
template <typename T>
__device__ __forceinline__ void block_sum(T (&acc)[kDots]) {
  __shared__ T red[kDots][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kDots; ++k) {
    T v = warp_sum(acc[k]);
    if (lane == 0) red[k][warp] = v;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < kDots; ++k) {
      T v = lane < kWarps ? red[k][lane] : T(0);
      acc[k] = warp_sum(v);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_dots_partial(const T* __restrict__ s, const T* __restrict__ y,
                   const T* __restrict__ r, const T* __restrict__ t,
                   const T* __restrict__ rs, int64_t n,
                   T* __restrict__ partials) {
  T acc[kDots];
#pragma unroll
  for (int k = 0; k < kDots; ++k) acc[k] = T(0);
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
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
  block_sum(acc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kDots; ++k) partials[(int64_t)blockIdx.x * kDots + k] = acc[k];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_dots_final(const T* __restrict__ partials, int nblocks,
                 T* __restrict__ out) {
  T acc[kDots];
#pragma unroll
  for (int k = 0; k < kDots; ++k) acc[k] = T(0);
  for (int b = threadIdx.x; b < nblocks; b += kThreads) {
#pragma unroll
    for (int k = 0; k < kDots; ++k) acc[k] += partials[(int64_t)b * kDots + k];
  }
  block_sum(acc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kDots; ++k) out[k] = acc[k];
  }
}

template <typename T>
int launch(const void* s, const void* y, const void* r, const void* t,
           const void* rs, int64_t n, void* partials, int nblocks, void* out,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fused_dots_partial<T><<<nblocks, kThreads, 0, st>>>(
      static_cast<const T*>(s), static_cast<const T*>(y),
      static_cast<const T*>(r), static_cast<const T*>(t),
      static_cast<const T*>(rs), n, static_cast<T*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_dots_final<T><<<1, kThreads, 0, st>>>(
      static_cast<const T*>(partials), nblocks, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// s, y, r, t, rs: n elements each; partials: nblocks * 9 scratch; out: 9.
// Returns the cudaError_t of the two launches (0 on success).
extern "C" int repro_fused_dots_f64(const void* s, const void* y, const void* r,
                                    const void* t, const void* rs, int64_t n,
                                    void* partials, int nblocks, void* out,
                                    void* stream) {
  return launch<double>(s, y, r, t, rs, n, partials, nblocks, out, stream);
}

extern "C" int repro_fused_dots_f32(const void* s, const void* y, const void* r,
                                    const void* t, const void* rs, int64_t n,
                                    void* partials, int nblocks, void* out,
                                    void* stream) {
  return launch<float>(s, y, r, t, rs, n, partials, nblocks, out, stream);
}
