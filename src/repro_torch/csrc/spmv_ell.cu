// spmv_ell: ELLPACK sparse matrix-vector product
//
//   y[r] = sum_j values[r, j] * x[cols[r, j]],   values/cols (n, k), cols int32
//
// Replaces src/repro/kernels/spmv_ell.py:spmv_ell_pallas.
//
// What bounds it on an H100: bytes.  Each row reads k values (8 bytes in
// fp64) and k int32 column indices, gathers k entries of x and writes one
// y: at least k*12 + 16 bytes per row for 2k flops.
//
// Design.  One thread per row: it walks its k entries in order and gathers
// x[cols[r, j]] from device memory through the read-only cache.  The TPU
// kernel instead streams x through VMEM three blocks at a time and so only
// takes matrices whose band is below its block size (512); the JAX
// package's "pallas" substrate sends other ELL matrices to the plain path.
// A CUDA thread gathers from device memory and has no such window, so this
// kernel takes any ELL matrix and the port's "cuda" substrate sends every
// ELLOperator here, banded or not.  That is the one intended dispatch
// difference from the JAX package: the 7-point stencil at 108^3 has a band
// of 108*108 = 11,664 and would otherwise never reach the kernel.
// Neighbouring threads read rows k entries apart, so the values and cols
// loads coalesce only through L1; a transposed (k, n) layout or a warp per
// row is left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
spmv_ell_kernel(const T* __restrict__ values, const int32_t* __restrict__ cols,
                const T* __restrict__ x, T* __restrict__ y, int64_t n, int k) {
  const int64_t row = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (row >= n) return;
  const T* v = values + row * k;
  const int32_t* c = cols + row * k;
  T acc = T(0);
  for (int j = 0; j < k; ++j) acc += v[j] * __ldg(x + c[j]);
  y[row] = acc;
}

template <typename T>
int launch(const void* values, const void* cols, const void* x, void* y,
           int64_t n, int k, void* stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks == 0) return 0;
  spmv_ell_kernel<T><<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(values), static_cast<const int32_t*>(cols),
      static_cast<const T*>(x), static_cast<T*>(y), n, k);
  return (int)cudaGetLastError();
}

}  // namespace

// values (n, k) and cols (n, k) row-major; x and y (n,).  Every column index
// must lie in [0, n) (checked once when the operator is built).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int repro_spmv_ell_f64(const void* values, const void* cols,
                                  const void* x, void* y, int64_t n, int k,
                                  void* stream) {
  return launch<double>(values, cols, x, y, n, k, stream);
}

extern "C" int repro_spmv_ell_f32(const void* values, const void* cols,
                                  const void* x, void* y, int64_t n, int k,
                                  void* stream) {
  return launch<float>(values, cols, x, y, n, k, stream);
}
