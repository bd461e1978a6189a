// block_jacobi_apply: the block-Jacobi preconditioner's apply
//
//   y[g * bs + i] = sum_j B[g, i, j] * x[g * bs + j],
//   B (nb, bs, bs) row-major: the pre-inverted diagonal blocks; x, y (n,)
//   with n = nb * bs
//
// Replaces src/repro/kernels/precond_apply.py:block_jacobi_apply_pallas.
// The TPU kernel groups min(nb, 65536 // bs^2) blocks per grid step and
// zero-pads nb to a multiple of the group: that is its VMEM tiling, not
// part of the function, and has no counterpart here.
//
// What bounds it on an H100: bytes.  Each block is read once (bs^2
// elements, 32 KB at bs = 64 in fp64) for 2 bs^2 flops, 1/4 flop per byte
// in fp64, far below the card's balance point; x and y add 2 n elements.
//
// Design.  One block of threads per row block g, so nothing is carried
// between blocks.  x_g is staged once in shared memory (read from there by
// all bs rows).  Row i of B_g is contiguous: a group of W lanes (the
// smallest power of two >= bs, at most 8) takes one row, its lanes
// striding over j, so that one load instruction of a warp reads 4 rows'
// runs of 8 neighbouring elements, and a butterfly of shuffles inside the
// group (log2 W <= 3 levels, unrolled: W is a template parameter) adds the
// lanes' partial sums.  A whole warp per row (W = 32, this kernel's first
// design) was slower on the card in both types, most in fp32: its 5-level
// butterfly per row, not the loads, set the pace.  The butterfly is a
// fixed order (every lane ends with the same bits: the adds commute), there
// are no atomics, so a repeat is bitwise equal.  A row block is processed
// in passes of blockDim / W rows; every lane runs every pass (rows past bs
// add nothing), so each shuffle has all 32 lanes of its warp.  Where x_g
// does not fit the 48 KB of shared memory a block may take without opting
// in, the lanes read it from device memory instead (through the read-only
// cache).  nvcc contracts the multiply-add into an FMA and the sum runs in
// another order than the plain version's, so fp64 results differ from it
// in the last ulps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kSharedBytes = 48 * 1024;
constexpr int kMaxWidth = 8;

// Lanes per row: the smallest power of two >= bs, at most kMaxWidth.
inline int group_width(int bs) {
  int w = 1;
  while (w < bs && w < kMaxWidth) w <<= 1;
  return w;
}

// Threads per block: enough groups for bs rows in one pass, a whole number
// of warps, at most kMaxThreads.
inline int block_threads(int bs, int width) {
  const int64_t want = (int64_t)bs * width;
  const int64_t warps = (want + 31) / 32;
  return (int)(warps * 32 < kMaxThreads ? warps * 32 : kMaxThreads);
}

template <typename T, int W>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int W, bool kStaged>
__global__ void __launch_bounds__(kMaxThreads)
block_jacobi_apply_kernel(const T* __restrict__ blocks,
                          const T* __restrict__ x, T* __restrict__ y,
                          int bs) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  const int64_t g = blockIdx.x;
  const T* xg = x + g * bs;
  const T* bg = blocks + g * (int64_t)bs * bs;
  if (kStaged) {
    for (int j = threadIdx.x; j < bs; j += blockDim.x) xs[j] = xg[j];
    __syncthreads();
  }
  const int lane = threadIdx.x & (W - 1);
  const int group = threadIdx.x / W;
  const int groups = blockDim.x / W;
  for (int base = 0; base < bs; base += groups) {
    const int i = base + group;
    T acc = T(0);
    if (i < bs) {
      const T* row = bg + (int64_t)i * bs;
#pragma unroll 4
      for (int j = lane; j < bs; j += W)
        acc += row[j] * (kStaged ? xs[j] : __ldg(xg + j));
    }
    acc = group_sum<T, W>(acc);
    if (i < bs && lane == 0) y[g * bs + i] = acc;
  }
}

template <typename T, int W>
void launch_width(const T* b, const T* x, T* y, int64_t nb, int bs,
                  cudaStream_t s) {
  const int threads = block_threads(bs, W);
  const size_t shared = (size_t)bs * sizeof(T);
  if (shared <= (size_t)kSharedBytes)
    block_jacobi_apply_kernel<T, W, true>
        <<<(unsigned)nb, threads, shared, s>>>(b, x, y, bs);
  else
    block_jacobi_apply_kernel<T, W, false>
        <<<(unsigned)nb, threads, 0, s>>>(b, x, y, bs);
}

template <typename T>
int launch(const void* blocks, const void* x, void* y, int64_t nb, int bs,
           void* stream) {
  if (nb <= 0 || bs <= 0) return 0;
  if (nb > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* b = static_cast<const T*>(blocks);
  const T* xx = static_cast<const T*>(x);
  T* yy = static_cast<T*>(y);
  switch (group_width(bs)) {
    case 1: launch_width<T, 1>(b, xx, yy, nb, bs, s); break;
    case 2: launch_width<T, 2>(b, xx, yy, nb, bs, s); break;
    case 4: launch_width<T, 4>(b, xx, yy, nb, bs, s); break;
    default: launch_width<T, 8>(b, xx, yy, nb, bs, s); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// blocks (nb, bs, bs) row-major; x and y (nb * bs,).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int repro_block_jacobi_apply_f64(const void* blocks, const void* x,
                                            void* y, int64_t nb, int bs,
                                            void* stream) {
  return launch<double>(blocks, x, y, nb, bs, stream);
}

extern "C" int repro_block_jacobi_apply_f32(const void* blocks, const void* x,
                                            void* y, int64_t nb, int bs,
                                            void* stream) {
  return launch<float>(blocks, x, y, nb, bs, stream);
}
