// fused_dots: the 9 inner products of p-BiCGSafe's single reduction phase
// (paper Alg. 3.1 lines 7-8) in one pass over (s, y, r, t_prev, r0*):
//
//   out = [s.s, y.y, s.y, s.r, y.r, rs.r, rs.s, rs.t, r.r]
//
// and its guarded form, fused_dots_health, which reads the previous iterate
// x as a sixth operand and adds two health rows in the same pass:
//
//   out[9]  = x.x                        (the drift bound's ||x||^2)
//   out[10] = sum((((s + y) + t) + rs) + x)  (a NaN/Inf probe)
//
// Replaces src/repro/kernels/fused_dots.py:fused_dots_pallas and
// fused_dots_health_pallas.
//
// What bounds it on an H100: bytes.  It reads 5 (6) vectors once (40 (48)
// bytes per row in fp64) and does 18 (24) flops per row, far below the
// card's flop-per-byte balance, so its floor is 5 (6) * 8 * n bytes over the
// HBM rate.
//
// Design.  The TPU kernel walks the row blocks in order on one core and
// carries the sum in its output block.  Blocks on the GPU run in parallel
// and in no order, so the sum is taken in two kernels:
//   1. fused_dots_partial: a fixed number of blocks run a grid-stride loop
//      over the rows; each thread keeps its 9 (11) sums in registers
//      (double for fp64, float for fp32), then the block reduces them with
//      warp shuffles and shared memory and writes one row of (nblocks, rows)
//      partials.  Each element of the operands is read exactly once.
//   2. fused_dots_final: one block sums the partials in a fixed order.
// No atomics: for a given n the grid and every summation order are fixed,
// so the result repeats bitwise from run to run (an iteration count near
// the tolerance moves by 1-2 when the order changes).  Both forms are one
// template on the row count: rows 0-8 of the health form are summed in the
// same order as the 9-row form, so they agree bit for bit.  The probe row
// must carry NaN and Inf through: idle threads add 0, and nothing compares,
// clamps or takes a max (and the build has no --use_fast_math).
// Inputs are read with plain coalesced loads; vector loads and TMA are
// left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDots = 9;
constexpr int kHealthDots = 11;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Reduce the block's kRows per-thread sums; thread 0 ends with the totals
// in acc.  Every block reduces in the same order.
template <typename T, int kRows>
__device__ __forceinline__ void block_sum(T (&acc)[kRows]) {
  __shared__ T red[kRows][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    T v = warp_sum(acc[k]);
    if (lane == 0) red[k][warp] = v;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      T v = lane < kWarps ? red[k][lane] : T(0);
      acc[k] = warp_sum(v);
    }
  }
}

// x is read only by the 11-row form (it may be null for the 9-row one).
template <typename T, int kRows>
__global__ void __launch_bounds__(kThreads)
fused_dots_partial(const T* __restrict__ s, const T* __restrict__ y,
                   const T* __restrict__ r, const T* __restrict__ t,
                   const T* __restrict__ rs, const T* __restrict__ x,
                   int64_t n, T* __restrict__ partials) {
  T acc[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) acc[k] = T(0);
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
    if constexpr (kRows == kHealthDots) {
      const T xv = x[i];
      acc[9] += xv * xv;
      acc[10] += (((sv + yv) + tv) + qv) + xv;
    }
  }
  block_sum<T, kRows>(acc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) partials[(int64_t)blockIdx.x * kRows + k] = acc[k];
  }
}

template <typename T, int kRows>
__global__ void __launch_bounds__(kThreads)
fused_dots_final(const T* __restrict__ partials, int nblocks,
                 T* __restrict__ out) {
  T acc[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) acc[k] = T(0);
  for (int b = threadIdx.x; b < nblocks; b += kThreads) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) acc[k] += partials[(int64_t)b * kRows + k];
  }
  block_sum<T, kRows>(acc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) out[k] = acc[k];
  }
}

template <typename T, int kRows>
int launch(const void* s, const void* y, const void* r, const void* t,
           const void* rs, const void* x, int64_t n, void* partials,
           int nblocks, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fused_dots_partial<T, kRows><<<nblocks, kThreads, 0, st>>>(
      static_cast<const T*>(s), static_cast<const T*>(y),
      static_cast<const T*>(r), static_cast<const T*>(t),
      static_cast<const T*>(rs), static_cast<const T*>(x), n,
      static_cast<T*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_dots_final<T, kRows><<<1, kThreads, 0, st>>>(
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
  return launch<double, kDots>(s, y, r, t, rs, nullptr, n, partials, nblocks,
                               out, stream);
}

extern "C" int repro_fused_dots_f32(const void* s, const void* y, const void* r,
                                    const void* t, const void* rs, int64_t n,
                                    void* partials, int nblocks, void* out,
                                    void* stream) {
  return launch<float, kDots>(s, y, r, t, rs, nullptr, n, partials, nblocks,
                              out, stream);
}

// The guarded form: x is the sixth operand (n elements); partials:
// nblocks * 11 scratch; out: 11.
extern "C" int repro_fused_dots_health_f64(const void* s, const void* y,
                                           const void* r, const void* t,
                                           const void* rs, const void* x,
                                           int64_t n, void* partials,
                                           int nblocks, void* out,
                                           void* stream) {
  return launch<double, kHealthDots>(s, y, r, t, rs, x, n, partials, nblocks,
                                     out, stream);
}

extern "C" int repro_fused_dots_health_f32(const void* s, const void* y,
                                           const void* r, const void* t,
                                           const void* rs, const void* x,
                                           int64_t n, void* partials,
                                           int nblocks, void* out,
                                           void* stream) {
  return launch<float, kHealthDots>(s, y, r, t, rs, x, n, partials, nblocks,
                                    out, stream);
}
