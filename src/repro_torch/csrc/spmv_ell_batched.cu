// spmv_ell_batched: ELLPACK sparse matrix times a block of m vectors
//
//   Y[r, j] = sum_k values[r, k] * X[cols[r, k], j],
//   values/cols (n, k) row-major, cols int32; X, Y (n, m) row-major
//
// Replaces src/repro/kernels/spmv_ell.py:spmv_ell_batched_pallas.
//
// What bounds it on an H100: bytes.  Each row reads k values and k int32
// column indices once for all m columns, gathers k * m entries of X and
// writes m of Y: at least k * 12 + 16 * m bytes per row in fp64 (X is read
// once in all when its rows are reused through the cache, as a stencil's
// are) for 2 k m flops.
//
// Design.  One thread per (row, column) element e = r * m + j, so the
// m threads of a row are neighbours in the warp: they read the same
// values[r, :] and cols[r, :] (one DRAM fetch, broadcast within the warp),
// and each gather X[cols[r, k] * m + j] is a contiguous run of m elements.
// The TPU kernel streams X through VMEM three row blocks at a time and so
// only takes matrices whose band is below its block size; this kernel
// gathers from device memory and takes any ELL matrix, like spmv_ell.cu
// (the 7-point stencil at 108^3 has a band of 11,664).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
spmv_ell_batched_kernel(const T* __restrict__ values,
                        const int32_t* __restrict__ cols,
                        const T* __restrict__ x, T* __restrict__ y,
                        int64_t total, int m, int k) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const int64_t row = e / m;
  const int j = (int)(e - row * m);
  const T* v = values + row * k;
  const int32_t* c = cols + row * k;
  T acc = T(0);
  for (int kk = 0; kk < k; ++kk)
    acc += v[kk] * __ldg(x + (int64_t)c[kk] * m + j);
  y[e] = acc;
}

template <typename T>
int launch(const void* values, const void* cols, const void* x, void* y,
           int64_t n, int m, int k, void* stream) {
  const int64_t total = n * m;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks == 0) return 0;
  spmv_ell_batched_kernel<T><<<(unsigned)blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(values), static_cast<const int32_t*>(cols),
      static_cast<const T*>(x), static_cast<T*>(y), total, m, k);
  return (int)cudaGetLastError();
}

}  // namespace

// values (n, k) and cols (n, k) row-major; x and y (n, m) row-major.  Every
// column index must lie in [0, n) (checked once when the operator is
// built).  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_spmv_ell_batched_f64(const void* values, const void* cols,
                                          const void* x, void* y, int64_t n,
                                          int m, int k, void* stream) {
  return launch<double>(values, cols, x, y, n, m, k, stream);
}

extern "C" int repro_spmv_ell_batched_f32(const void* values, const void* cols,
                                          const void* x, void* y, int64_t n,
                                          int m, int k, void* stream) {
  return launch<float>(values, cols, x, y, n, m, k, stream);
}
