// block_jacobi_apply_batched: the block-Jacobi apply on m right-hand sides
//
//   Y[g * bs + i, c] = sum_j B[g, i, j] * X[g * bs + j, c],
//   B (nb, bs, bs) row-major; X, Y (n, m) row-major with n = nb * bs, so
//   X_g = X[g * bs : (g + 1) * bs, :] is one contiguous (bs, m) slab
//
// Replaces src/repro/kernels/precond_apply.py:
// block_jacobi_apply_batched_pallas, whose point is that one load of the
// block tile serves all m columns.  (Its group padding of nb is TPU tiling
// and has no counterpart here.)
//
// What bounds it on an H100: bytes.  The blocks (bs^2 elements per row
// block) are read once for all columns, X and Y add 2 n m elements: at
// bs = 64, m = 8, fp64, 806 MB for 2 n bs m flops (1 flop per byte).
//
// Design.  One block of threads per (row block g, tile of up to kTile = 8
// columns): blockIdx.x = g, blockIdx.y = the column tile, so at m <= 8 each
// row of B_g is read once.  The tile of X_g is staged once in shared
// memory, transposed (column c of the tile at xs[c * (bs + 1) + j]; the +1
// keeps the transposing writes off one bank), so lanes reading neighbouring
// j of one column hit neighbouring words.  As in block_jacobi_apply.cu, a
// group of W lanes takes row i of B_g, each lane striding over j and
// keeping a running sum per column of the tile in registers (the tile's
// width is a template parameter, picked once per block, so the column
// loops unroll); each row element is loaded once and multiplied into every
// column.  W is
// the smallest power of two >= bs, at most one 32-byte sector of a row per
// load (4 lanes in fp64, 8 in fp32): the fewer lanes per row, the fewer
// butterfly levels per column, and with 8 columns to add up the butterflies
// outweigh the loads (a warp per row, this kernel's first design, took
// about 1.6x its bound on the card).  A butterfly of shuffles per column
// adds the lanes' sums in a fixed order (no atomics: a repeat is bitwise
// equal); lane c % W of the group writes column c (at W = 8 in one store
// for the row).  Where the staged tile does not fit 48 KB of shared memory
// (bs > 767 in fp64) the lanes read X_g from device memory instead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kSharedBytes = 48 * 1024;
constexpr int kTile = 8;        // columns per block of threads (registers)

// Lanes per row: the smallest power of two >= bs, at most 32 bytes of a
// row per load.
template <typename T>
inline int group_width(int bs) {
  const int cap = 32 / (int)sizeof(T);
  int w = 1;
  while (w < bs && w < cap) w <<= 1;
  return w;
}

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

// One tile of MT columns (MT a template parameter, so the running sums stay
// in registers and every loop over the columns unrolls).
template <typename T, int W, int MT, bool kStaged>
__device__ __forceinline__ void apply_tile(const T* __restrict__ bg,
                                           const T* __restrict__ xg,
                                           const T* __restrict__ xs,
                                           T* __restrict__ yg, int bs,
                                           int m) {
  const int ld = bs + 1;
  const int lane = threadIdx.x & (W - 1);
  const int group = threadIdx.x / W;
  const int groups = blockDim.x / W;
  for (int base = 0; base < bs; base += groups) {
    const int i = base + group;
    T acc[MT];
#pragma unroll
    for (int c = 0; c < MT; ++c) acc[c] = T(0);
    if (i < bs) {
      const T* row = bg + (int64_t)i * bs;
#pragma unroll 4
      for (int j = lane; j < bs; j += W) {
        const T b = row[j];
#pragma unroll
        for (int c = 0; c < MT; ++c)
          acc[c] += b * (kStaged ? xs[c * ld + j]
                                 : __ldg(xg + (int64_t)j * m + c));
      }
    }
    T* yrow = yg + (int64_t)i * m;
    T out = T(0);
#pragma unroll
    for (int c = 0; c < MT; ++c) {
      const T v = group_sum<T, W>(acc[c]);
      if ((c & (W - 1)) == lane) {
        if (W >= MT) out = v;                     // lane c keeps column c
        else if (i < bs) yrow[c] = v;
      }
    }
    // W >= MT: one store of the row's MT neighbouring outputs
    if (W >= MT && i < bs && lane < MT) yrow[lane] = out;
  }
}

template <typename T, int W, bool kStaged>
__global__ void __launch_bounds__(kMaxThreads)
block_jacobi_apply_batched_kernel(const T* __restrict__ blocks,
                                  const T* __restrict__ x,
                                  T* __restrict__ y, int bs, int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  const int ld = bs + 1;
  const int64_t g = blockIdx.x;
  const int c0 = blockIdx.y * kTile;
  const int mt = min(kTile, m - c0);          // columns of this tile
  const T* xg = x + g * bs * (int64_t)m + c0;  // X_g[:, c0:]
  T* yg = y + g * bs * (int64_t)m + c0;
  const T* bg = blocks + g * (int64_t)bs * bs;
  if (kStaged) {
    for (int e = threadIdx.x; e < bs * mt; e += blockDim.x) {
      const int j = e / mt, c = e - j * mt;
      xs[c * ld + j] = xg[(int64_t)j * m + c];
    }
    __syncthreads();
  }
  switch (mt) {                 // the same for the whole block
    case 8: apply_tile<T, W, 8, kStaged>(bg, xg, xs, yg, bs, m); break;
    case 7: apply_tile<T, W, 7, kStaged>(bg, xg, xs, yg, bs, m); break;
    case 6: apply_tile<T, W, 6, kStaged>(bg, xg, xs, yg, bs, m); break;
    case 5: apply_tile<T, W, 5, kStaged>(bg, xg, xs, yg, bs, m); break;
    case 4: apply_tile<T, W, 4, kStaged>(bg, xg, xs, yg, bs, m); break;
    case 3: apply_tile<T, W, 3, kStaged>(bg, xg, xs, yg, bs, m); break;
    case 2: apply_tile<T, W, 2, kStaged>(bg, xg, xs, yg, bs, m); break;
    default: apply_tile<T, W, 1, kStaged>(bg, xg, xs, yg, bs, m); break;
  }
}

template <typename T, int W>
void launch_width(const T* b, const T* x, T* y, int64_t nb, int bs, int m,
                  int tiles, cudaStream_t s) {
  const int threads = block_threads(bs, W);
  const size_t shared = (size_t)kTile * (bs + 1) * sizeof(T);
  const dim3 grid((unsigned)nb, (unsigned)tiles);
  if (shared <= (size_t)kSharedBytes)
    block_jacobi_apply_batched_kernel<T, W, true>
        <<<grid, threads, shared, s>>>(b, x, y, bs, m);
  else
    block_jacobi_apply_batched_kernel<T, W, false>
        <<<grid, threads, 0, s>>>(b, x, y, bs, m);
}

template <typename T>
int launch(const void* blocks, const void* x, void* y, int64_t nb, int bs,
           int m, void* stream) {
  if (nb <= 0 || bs <= 0 || m <= 0) return 0;
  const int tiles = (m + kTile - 1) / kTile;
  if (nb > 0x7fffffff || tiles > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* b = static_cast<const T*>(blocks);
  const T* xx = static_cast<const T*>(x);
  T* yy = static_cast<T*>(y);
  switch (group_width<T>(bs)) {
    case 1: launch_width<T, 1>(b, xx, yy, nb, bs, m, tiles, s); break;
    case 2: launch_width<T, 2>(b, xx, yy, nb, bs, m, tiles, s); break;
    case 4: launch_width<T, 4>(b, xx, yy, nb, bs, m, tiles, s); break;
    default: launch_width<T, 8>(b, xx, yy, nb, bs, m, tiles, s); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// blocks (nb, bs, bs) row-major; x and y (nb * bs, m) row-major.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int repro_block_jacobi_apply_batched_f64(const void* blocks,
                                                    const void* x, void* y,
                                                    int64_t nb, int bs, int m,
                                                    void* stream) {
  return launch<double>(blocks, x, y, nb, bs, m, stream);
}

extern "C" int repro_block_jacobi_apply_batched_f32(const void* blocks,
                                                    const void* x, void* y,
                                                    int64_t nb, int bs, int m,
                                                    void* stream) {
  return launch<float>(blocks, x, y, nb, bs, m, stream);
}
