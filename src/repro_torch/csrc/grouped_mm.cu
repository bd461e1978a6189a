// grouped_mm: the grouped (ragged) matrix product of the dropless MoE
// dispatch in f32 and f64 on the CUDA cores (the "simt" route; bf16 goes
// through grouped_mm_sm90.cu's "wgmma" route)
//
//   y[r, :] = x[r, :] @ w[e]   for offsets[e] <= r < offsets[e + 1]
//
//   x (R, K) row-major, its rows sorted by expert; w (E, K, N) row-major
//   (N contiguous); offsets (E + 1,) int64 on the device, offsets[0] = 0,
//   offsets[E] = R, non-decreasing; y (R, N); any K and N.
//
// Replaces no Pallas kernel.  It stands in for jax.lax.ragged_dot, which
// the JAX package's sort dispatch (src/repro/models/moe.py _moe_sort) calls
// three times a layer and XLA lowers on its own, for any float type.  The
// port needs it by hand because the group sizes live on the device: a loop
// over the experts would read them to the host every call, and a step with
// such a read cannot be captured as a CUDA graph.  Nothing about the
// routing is a launch argument: the grid depends on (R, E, N) alone, so one
// graph serves every routing, and each block finds its row tile in the
// offsets in device memory (grouped_tiles.cuh).
//
// What bounds it on an H100.  At deepseek-v3's `wi` (K 7,168, N 2,048) and
// a prefill's R = 32,768 rows: the products, 0.962 TFLOP, 14.4 ms at the
// 67 TFLOP/s of the fp64 tensor cores (fp64) and 5.8 ms for three TF32
// passes at 495 TFLOP/s (f32, the least that keeps f32's digits), against
// 32.4 / 16.2 GB of bytes, 9.7 / 4.8 ms.  This design reaches neither: FMA
// on the CUDA cores (67 and 34 TFLOP/s of peak) fed element by element
// from shared memory; 56.9 ms in f32 and 82.5 in f64 on an H100 80GB HBM3
// at 700 W, where torch._grouped_mm takes 28.7 in f32 (ROADMAP section B).

#include "grouped_tiles.cuh"

namespace {

constexpr int64_t kMaxTiles = 65535;   // the grid's y extent

// The f32 and f64 route: FMA on the CUDA cores, the sums in the operands'
// type (TF32 would miss the plain version's f32 products), 64 x 64 tiles of
// one expert's rows found from the offsets (grouped_tiles.cuh), 16-deep
// stages in shared memory loaded element by element, so K and N need no
// alignment.
// 256 threads, 16 x 16, each sums a 4 x 4 block of outputs strided by 16
// rows and 16 columns (the x tile is kept K-major, [k][m], so a warp's 16
// threads of one row read one word and its B reads run along the row).
constexpr int kSM = 64;
constexpr int kSN = 64;
constexpr int kSK = 16;
constexpr int kSThreads = 256;

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T>
__global__ void __launch_bounds__(kSThreads)
grouped_mm_simt_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const int64_t* __restrict__ offsets, T* __restrict__ y,
                       int64_t R, int K, int N, int E) {
  __shared__ T as[kSK][kSM + 1];
  __shared__ T bs[kSK][kSN];
  __shared__ int s_expert;
  __shared__ int64_t s_row0, s_row1;
  const int tid = threadIdx.x;
  if (tid < 32) {
    const RowTile tile = find_row_tile<kSM>(offsets, blockIdx.y, E, R);
    if (tid == 0) {
      s_expert = tile.expert;
      s_row0 = tile.row0;
      s_row1 = tile.row1;
    }
  }
  __syncthreads();
  const int e = s_expert;
  if (e < 0) return;                             // past the last tile
  const int64_t r0 = s_row0;
  const int rows = (int)(s_row1 - r0);
  const int n0 = blockIdx.x * kSN;
  const T* we = w + (int64_t)e * K * N;
  const int tx = tid & 15, ty = tid >> 4;
  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);
  for (int k0 = 0; k0 < K; k0 += kSK) {
    for (int c = tid; c < kSM * kSK; c += kSThreads) {
      const int m = c / kSK, k = c - m * kSK;
      as[k][m] = m < rows && k0 + k < K ? x[(r0 + m) * K + k0 + k] : T(0);
    }
    for (int c = tid; c < kSK * kSN; c += kSThreads) {
      const int k = c / kSN, n = c - k * kSN;
      bs[k][n] = k0 + k < K && n0 + n < N ? we[(int64_t)(k0 + k) * N + n0 + n]
                                          : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSK; ++k) {
      T a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma_t(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty + 16 * i;
    if (m >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) y[(r0 + m) * N + col] = acc[i][j];
    }
  }
}

template <typename T>
int launch_simt(const void* x, const void* w, const void* offsets, void* y,
                int64_t R, int K, int N, int E, void* stream) {
  if (R <= 0 || N <= 0) return 0;
  const int64_t tiles = max_row_tiles<kSM>(R, E);
  if (K < 0 || E <= 0 || tiles > kMaxTiles) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kSN - 1) / kSN, (unsigned)tiles);
  grouped_mm_simt_kernel<T>
      <<<grid, kSThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<const T*>(w),
          static_cast<const int64_t*>(offsets), static_cast<T*>(y), R, K, N,
          E);
  return (int)cudaGetLastError();
}

}  // namespace

// x (R, K), w (E, K, N), y (R, N): device pointers to float (f32) or
// double (f64); offsets: a device pointer to E + 1 int64; any K and N, no
// alignment.  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_grouped_mm_f32(const void* x, const void* w,
                                    const void* offsets, void* y, int64_t R,
                                    int K, int N, int E, void* stream) {
  return launch_simt<float>(x, w, offsets, y, R, K, N, E, stream);
}

extern "C" int repro_grouped_mm_f64(const void* x, const void* w,
                                    const void* offsets, void* y, int64_t R,
                                    int K, int N, int E, void* stream) {
  return launch_simt<double>(x, w, offsets, y, R, K, N, E, stream);
}
