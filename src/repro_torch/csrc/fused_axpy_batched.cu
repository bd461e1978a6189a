// fused_axpy_batched: p-BiCGSafe's vector-update phase (paper Alg. 3.1
// lines 23-32) for m right-hand sides at once: 12 (n, m) row-major blocks
// and per-column coefficients in, 10 (n, m) blocks out.  Column j uses its
// own (alpha_j, beta_j, zeta_j, eta_j):
//
//   p' = r + be (p - u)          o  = s + be t
//   u' = ze o + et (y + be u)    q  = As + be l
//   w' = ze q + et (g + be w)    t' = o - w'
//   z' = ze r + et z - al u'     y' = ze s + et y - al w'
//   x' = x + al p' + z'          r' = r - al o - y'
//
// and a column whose mask is 0 (converged, broken down or out of budget)
// is frozen: every output with an input of the same name (p u w t z y x r,
// MASKED_OUT in kernels/fused_axpy.py) is that input, bit for bit; o and q
// are always the fresh values.
//
// Replaces src/repro/kernels/fused_axpy.py:fused_axpy_batched_pallas, with
// its input order (IN_ORDER: r p u t y z s l g w x As) and output order
// (OUT_ORDER: p o u q w t z y x r).
//
// What bounds it on an H100: bytes.  22 blocks cross HBM (12 read, 10
// written: 176 * m bytes per row in fp64) for about 40 flops per element.
//
// Design.  One thread per element e of the flattened (n, m) blocks, so the
// warp's loads and stores are contiguous; its column is e % m.  The
// coefficients come from a (4, m) device tensor and the mask from an (m,)
// uint8 device tensor, never from the host, so the solver's loop never
// reads a coefficient back.  The mask is a select, not a blend: a frozen
// column's coefficients can be NaN or Inf (a zero column's relres is
// 0 / 0), and mask * new + (1 - mask) * old would carry them into the
// state that is meant to stay frozen.  A null mask advances every column.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIn = 12;
constexpr int kOut = 10;

template <typename T>
struct Args {
  const T* in[kIn];   // r p u t y z s l g w x As
  T* out[kOut];       // p o u q w t z y x r
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_axpy_batched_kernel(const Args<T> a, const T* __restrict__ scal,
                          const uint8_t* __restrict__ mask, int64_t total,
                          int m) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const int j = (int)(e % m);
  const T al = scal[j], be = scal[m + j], ze = scal[2 * m + j],
          et = scal[3 * m + j];
  const T r = a.in[0][e], p = a.in[1][e], u = a.in[2][e], t = a.in[3][e];
  const T y = a.in[4][e], z = a.in[5][e], s = a.in[6][e], l = a.in[7][e];
  const T g = a.in[8][e], w = a.in[9][e], x = a.in[10][e], As = a.in[11][e];

  const T o = s + be * t;
  const T q = As + be * l;
  a.out[1][e] = o;
  a.out[3][e] = q;
  if (mask != nullptr && mask[j] == 0) {
    a.out[0][e] = p;
    a.out[2][e] = u;
    a.out[4][e] = w;
    a.out[5][e] = t;
    a.out[6][e] = z;
    a.out[7][e] = y;
    a.out[8][e] = x;
    a.out[9][e] = r;
    return;
  }
  const T p2 = r + be * (p - u);
  const T u2 = ze * o + et * (y + be * u);
  const T w2 = ze * q + et * (g + be * w);
  const T t2 = o - w2;
  const T z2 = ze * r + et * z - al * u2;
  const T y2 = ze * s + et * y - al * w2;
  const T x2 = x + al * p2 + z2;
  const T r2 = r - al * o - y2;

  a.out[0][e] = p2;
  a.out[2][e] = u2;
  a.out[4][e] = w2;
  a.out[5][e] = t2;
  a.out[6][e] = z2;
  a.out[7][e] = y2;
  a.out[8][e] = x2;
  a.out[9][e] = r2;
}

template <typename T>
int launch(const void* const* ins, void* const* outs, const void* scal,
           const void* mask, int64_t n, int m, void* stream) {
  Args<T> a;
  for (int k = 0; k < kIn; ++k) a.in[k] = static_cast<const T*>(ins[k]);
  for (int k = 0; k < kOut; ++k) a.out[k] = static_cast<T*>(outs[k]);
  const int64_t total = n * m;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks == 0) return 0;
  fused_axpy_batched_kernel<T><<<(unsigned)blocks, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const T*>(scal), static_cast<const uint8_t*>(mask),
      total, m);
  return (int)cudaGetLastError();
}

}  // namespace

// ins: host array of 12 device pointers (IN_ORDER) to (n, m) blocks; outs:
// host array of 10 (OUT_ORDER); scal: device pointer to the (4, m)
// coefficients (alpha, beta, zeta, eta rows); mask: device pointer to m
// bytes (0 = frozen) or null.  Returns the cudaError_t of the launch.
extern "C" int repro_fused_axpy_batched_f64(const void* const* ins,
                                            void* const* outs,
                                            const void* scal, const void* mask,
                                            int64_t n, int m, void* stream) {
  return launch<double>(ins, outs, scal, mask, n, m, stream);
}

extern "C" int repro_fused_axpy_batched_f32(const void* const* ins,
                                            void* const* outs,
                                            const void* scal, const void* mask,
                                            int64_t n, int m, void* stream) {
  return launch<float>(ins, outs, scal, mask, n, m, stream);
}
