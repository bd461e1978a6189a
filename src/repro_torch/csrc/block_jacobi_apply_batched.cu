// block_jacobi_apply_batched: the block-Jacobi apply on m right-hand sides
//
//   Y[g * bs + i, c] = sum_j B[g, i, j] * X[g * bs + j, c],
//   B (nb, bs, bs) row-major; X, Y (n, m) row-major with n = nb * bs, so
//   B_g is one contiguous run of bs * bs elements and X_g = X[g * bs :
//   (g + 1) * bs, :] one of bs * m
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
// Two routes, chosen by shape in Python (repro_torch/kernels/
// precond_apply.py: batched_route) and passed in as `route`; a route whose
// conditions the operands do not meet is refused with an error, never
// swapped for another.
//
// The bulk routes (route 1 "bulk", route 2 "bulk_x_direct"): a persistent
// kernel that streams the blocks through shared memory.  Conditions: a row
// of B_g is a multiple of 16 bytes (bs even in fp64, a multiple of 4 in
// fp32), bs >= 32, the pointers 16-byte aligned, and two stages fit the
// ring (below).
//   * Grid: one block of 9 warps per SM (multiProcessorCount, queried), at
//     most nb; block b takes the row blocks g = b, b + gridDim.x, ...  Each
//     y_g is computed by one group of warps in a fixed order, so a repeat
//     is bitwise equal whichever block takes g.
//   * A ring of S stages in dynamic shared memory (the ring's 224 KB over
//     the stage's bytes, at most 8, rounded down to an even count: at bs =
//     64, m = 8 six stages of 36 KB in fp64, eight of 18 KB in fp32), with
//     a "full" and an "empty" mbarrier per stage.  One producer warp waits
//     for a stage to be empty, arms its full barrier with
//     mbarrier.arrive.expect_tx for the stage's exact bytes, and issues
//     cp.async.bulk copies (global -> shared, completing on that barrier):
//     B_g in 8 chunks of R = ceil(bs / 8) rows, each followed by 32 bytes
//     of padding in fp64 (16 in fp32), and on the bulk route X_g as one run
//     after them.  Few large copies: with
//     one copy per row (65 per row block) the kernel took as long in fp32
//     as in fp64 on the card, bound by the copies' count, not their
//     bytes.  Up to S - 2 stages are in flight per SM while the consumers
//     work on two.
//   * Two consumer groups of 4 warps take alternate row blocks, so each
//     owns the stages of its parity.  A group waits on the full barrier,
//     computes y_g, and releases the stage: each warp arrives once on the
//     empty barrier after a __syncwarp.  Lane (r, q) = (lane / 4, lane % 4)
//     takes rows r R + t (row t of chunk r: the 8 rows that one read
//     touches lie in the 8 chunks, which the padding puts in distinct
//     banks; unpadded rows of 512 bytes would all start in the same bank)
//     and columns c0 + 2q, c0 + 2q + 1 of each tile of 8 columns.
//       fp64: on the tensor cores, mma.sync m16n8k16 (sm_90's DMMA shape;
//       Ampere's m8n8k4, and fp64 FMAs before it, left the arithmetic in
//       the way of the copies), each warp a
//       16 x 8 tile of rows t and t + 1 of the chunks, k in steps of 16
//       (zeros past bs and m) into two sums added at the end.
//       fp32: on the CUDA cores (TF32 would break the tolerance), each lane
//       two rows, B as 16-byte vectors, X as column pairs where m is even
//       (the template flag kPair; else single elements), sums over j in
//       order.
//     Y goes out with plain stores.
//   * m > 8: the consumers loop over the tiles of 8 columns while the
//     stage holds B_g, so every B_g is read from device memory once per
//     call whatever m is.  Where X_g (bs * m elements) would leave fewer
//     than two stages (fp64 at bs = 64 past m = 159), route 2 copies only
//     B_g into the ring and the consumers read X_g's column tiles straight
//     from device memory (through the L1 cache).
//   * A wrong barrier parity would hang rather than fail: every wait gives
//     up after 2 s with a trap, which the next synchronize reports
//     (mbarrier.cuh).
//   * What bounds it: the streaming itself.  tools/block_jacobi_probe.py
//     times this pipeline with the arithmetic taken out (the copies and
//     Y's stores only) beside the whole kernel.

// The rows route (route 0): every other shape (bs < 32, rows that are not
// a multiple of 16 bytes, a B_g too large for two stages, unaligned
// pointers).  One block of threads per (row block g, tile of up to kTile =
// 8 columns): blockIdx.x = g, blockIdx.y = the column tile.  The tile of
// X_g is staged once in shared memory, transposed (column c of the tile at
// xs[c * (bs + 1) + j]; the +1 keeps the transposing writes off one bank).
// As in block_jacobi_apply.cu, a group of W lanes takes row i of B_g, each
// lane striding over j and keeping a running sum per column of the tile in
// registers; W is the smallest power of two >= bs, at most one 32-byte
// sector of a row per load.  A butterfly of shuffles per column adds the
// lanes' sums in a fixed order (no atomics: a repeat is bitwise equal).
// Where the staged tile does not fit 48 KB of shared memory (bs > 767 in
// fp64) the lanes read X_g from device memory instead.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "mbarrier.cuh"
#include "mma_fp32_fp64.cuh"

namespace {

// ---- the rows route ---------------------------------------------------


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
rows_kernel(const T* __restrict__ blocks, const T* __restrict__ x,
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
void launch_rows_width(const T* b, const T* x, T* y, int64_t nb, int bs,
                       int m, int tiles, cudaStream_t s) {
  const int threads = block_threads(bs, W);
  const size_t shared = (size_t)kTile * (bs + 1) * sizeof(T);
  const dim3 grid((unsigned)nb, (unsigned)tiles);
  if (shared <= (size_t)kSharedBytes)
    rows_kernel<T, W, true><<<grid, threads, shared, s>>>(b, x, y, bs, m);
  else
    rows_kernel<T, W, false><<<grid, threads, 0, s>>>(b, x, y, bs, m);
}

// ---- the bulk routes --------------------------------------------------

constexpr int kConsumerWarps = 8;
constexpr int kBulkThreads = (kConsumerWarps + 1) * 32;  // + the producer
// two consumer groups of 4 warps take alternate row blocks; each owns the
// stages of its parity (the stage count is even), so every wait on a
// barrier is for the phase after the one its group last saw complete (a
// group that waited on a stage the other group had not yet released would
// read the parity of the phase before and pass at once)
constexpr int kGroups = 2;
constexpr int kWarps = kConsumerWarps / kGroups;
constexpr int kMaxStages = 8;
constexpr int kRingBytes = 224 * 1024;   // the stages; the barriers take 128
constexpr int kBarrierBytes = 2 * kMaxStages * 8;
constexpr int kChunks = 8;     // copies of B_g, one per lane / 4
// bytes after each chunk: 8 rows that one load reads, one per chunk, fall
// in distinct banks (16-byte reads in fp32, 32-byte rows of an mma
// operand in fp64)
template <typename T>
__host__ __device__ constexpr int chunk_pad() {
  return sizeof(T) == 8 ? 32 : 16;
}
constexpr int kMinBulkRows = 32;

enum Route { kRows = 0, kBulk = 1, kBulkXDirect = 2 };

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on barrier `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

template <typename T> struct Vec16;   // 16 bytes of T
template <> struct Vec16<double> { using type = double2; };
template <> struct Vec16<float> { using type = float4; };
template <typename T> struct Pair;    // two T
template <> struct Pair<double> { using type = double2; };
template <> struct Pair<float> { using type = float2; };

__device__ __forceinline__ void unpack(const double2& v, double (&e)[2]) {
  e[0] = v.x;
  e[1] = v.y;
}
__device__ __forceinline__ void unpack(const float4& v, float (&e)[4]) {
  e[0] = v.x;
  e[1] = v.y;
  e[2] = v.z;
  e[3] = v.w;
}

// X[j, c] and X[j, c + 1] of the (bs, m) slab at xg (shared memory on the
// bulk route, device memory on bulk_x_direct); the second is 0 past m
template <typename T, bool kPair, bool kXStaged>
__device__ __forceinline__ void load_x(const T* xr, bool second, T& x0,
                                       T& x1) {
  using P = typename Pair<T>::type;
  if (kPair) {
    const P p = kXStaged ? *reinterpret_cast<const P*>(xr)
                         : __ldg(reinterpret_cast<const P*>(xr));
    x0 = p.x;
    x1 = p.y;
  } else {
    x0 = kXStaged ? xr[0] : __ldg(xr);
    x1 = second ? (kXStaged ? xr[1] : __ldg(xr + 1)) : T(0);
  }
}

// y_g = B_g X_g for the row block held in one stage, by the kWarps warps
// of one consumer group, on the CUDA cores (fp32): lane (r, q) of warp w
// takes rows i = r R + t for t = w, w + kWarps, ... (row t of chunk r, R =
// ceil(bs / 8) rows a chunk, the chunks `cs` elements apart), two at a
// time (each X pair it loads serves both), and columns c0 + 2q and
// c0 + 2q + 1 of each tile of 8
template <typename T, bool kPair, bool kXStaged>
__device__ __forceinline__ void consume(const T* __restrict__ sb, int cs,
                                        const T* __restrict__ xg,
                                        T* __restrict__ yg, int bs, int m,
                                        int warp, int lane) {
  using V = typename Vec16<T>::type;
  using P = typename Pair<T>::type;
  constexpr int kV = 16 / (int)sizeof(T);
  const int r = lane >> 2, q = lane & 3;
  const int rows = (bs + kChunks - 1) / kChunks;
  for (int c0 = 0; c0 < m; c0 += 8) {
    const int c = c0 + 2 * q;
    if (c >= m) continue;
    const bool second = c + 1 < m;
    for (int t = warp; t < rows; t += 2 * kWarps) {
      const int i0 = r * rows + t, i1 = i0 + kWarps;
      if (i0 >= bs) continue;
      const bool on1 = t + kWarps < rows && i1 < bs;
      const T* b0 = sb + (int64_t)r * cs + (int64_t)t * bs;
      const T* b1 = on1 ? b0 + (int64_t)kWarps * bs : b0;
      const T* xr = xg + c;
      T a[2][2] = {{T(0), T(0)}, {T(0), T(0)}};
#pragma unroll 2
      for (int j = 0; j < bs; j += kV) {
        T v0[kV], v1[kV];
        unpack(*reinterpret_cast<const V*>(b0 + j), v0);
        unpack(*reinterpret_cast<const V*>(b1 + j), v1);
#pragma unroll
        for (int e = 0; e < kV; ++e) {
          T x0, x1;
          load_x<T, kPair, kXStaged>(xr + (int64_t)(j + e) * m, second, x0,
                                     x1);
          a[0][0] += v0[e] * x0;
          a[0][1] += v0[e] * x1;
          a[1][0] += v1[e] * x0;
          a[1][1] += v1[e] * x1;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h == 1 && !on1) break;
        T* yr = yg + (int64_t)(h ? i1 : i0) * m + c;
        if (kPair) {
          P out;
          out.x = a[h][0];
          out.y = a[h][1];
          *reinterpret_cast<P*>(yr) = out;
        } else {
          yr[0] = a[h][0];
          if (second) yr[1] = a[h][1];
        }
      }
    }
  }
}

// y_g = B_g X_g in fp64 on the tensor cores, by the kWarps warps of one
// consumer group: the same rows and columns per lane as consume() (the
// mma's D layout).  Warp w takes the 16 x 8 tiles of rows {r R + t : r <
// 8, t = 2 u, 2 u + 1} (rows t of the 8 chunks, so the 8 rows of an A read
// lie in 8 chunks), u = w, w + kWarps, ..., and runs over k in steps of 16
// (zeros past bs and m) into 2 sums, one per k0 / 16 mod 2, so 2 products
// are in flight, added in a fixed order
template <bool kPair, bool kXStaged>
__device__ __forceinline__ void consume_mma(const double* __restrict__ sb,
                                            int cs,
                                            const double* __restrict__ xg,
                                            double* __restrict__ yg, int bs,
                                            int m, int warp, int lane) {
  using P = Pair<double>::type;
  const int r = lane >> 2, q = lane & 3;
  const int rows = (bs + kChunks - 1) / kChunks;
  for (int t0 = 2 * warp; t0 < rows; t0 += 2 * kWarps) {
    const int i0 = r * rows + t0, i1 = i0 + 1;
    const bool on0 = i0 < bs, on1 = t0 + 1 < rows && i1 < bs;
    const double* a0 = sb + (int64_t)r * cs + (int64_t)t0 * bs;
    const double* a1 = on1 ? a0 + bs : a0;
    for (int c0 = 0; c0 < m; c0 += 8) {
      const bool col_on = c0 + r < m;
      const double* xc = xg + c0 + r;
      double d[2][4] = {};
      for (int k0 = 0; k0 < bs; k0 += 32) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          double a[8], b[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = k0 + 16 * u + q + 4 * e;
            a[2 * e] = on0 && k < bs ? a0[k] : 0.0;
            a[2 * e + 1] = on1 && k < bs ? a1[k] : 0.0;
            b[e] = col_on && k < bs
                       ? (kXStaged ? xc[(int64_t)k * m]
                                   : __ldg(xc + (int64_t)k * m))
                       : 0.0;
          }
          dmma(d[u], a, b);
        }
      }
      const int c = c0 + 2 * q;
      if (c >= m) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!(h ? on1 : on0)) break;
        const double v0 = d[0][2 * h] + d[1][2 * h];
        const double v1 = d[0][2 * h + 1] + d[1][2 * h + 1];
        double* yr = yg + (int64_t)(h ? i1 : i0) * m + c;
        if (kPair) {
          P out;
          out.x = v0;
          out.y = v1;
          *reinterpret_cast<P*>(yr) = out;
        } else {
          yr[0] = v0;
          if (c + 1 < m) yr[1] = v1;
        }
      }
    }
  }
}

template <typename T, bool kPair, bool kXStaged>
__global__ void __launch_bounds__(kBulkThreads, 1)
bulk_kernel(const T* __restrict__ blocks, const T* __restrict__ x,
            T* __restrict__ y, int64_t nb, int bs, int m, int stages,
            int stage_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t full0 = smem_u32(smem);
  const uint32_t empty0 = full0 + kMaxStages * 8;
  unsigned char* ring = smem + kBarrierBytes;
  const int rows = (bs + kChunks - 1) / kChunks;  // rows of B_g a chunk
  const int cs = rows * bs + chunk_pad<T>() / (int)sizeof(T);
  const uint32_t b_bytes = (uint32_t)bs * bs * sizeof(T);
  const uint32_t x_bytes = kXStaged ? (uint32_t)bs * m * sizeof(T) : 0u;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {        // the producer
    int t = 0;
    for (int64_t g = blockIdx.x; g < nb; g += gridDim.x, ++t) {
      const int s = t % stages;
      const uint32_t parity = (uint32_t)(t / stages) & 1u;
      const uint32_t full = full0 + 8 * s;
      mbar_wait(empty0 + 8 * s, parity ^ 1u);  // round 0 passes at once
      if (lane == 0) mbar_arrive_expect_tx(full, b_bytes + x_bytes);
      __syncwarp();
      const uint32_t sb = smem_u32(ring + (size_t)s * stage_bytes);
      const T* gb = blocks + g * (int64_t)bs * bs;
      const int chunk_rows = min(rows, bs - lane * rows);
      if (lane < kChunks && chunk_rows > 0)
        bulk_copy(sb + (uint32_t)(lane * cs * sizeof(T)),
                  gb + (int64_t)lane * rows * bs,
                  (uint32_t)(chunk_rows * bs * sizeof(T)), full);
      if (kXStaged && lane == kChunks)
        bulk_copy(sb + (uint32_t)(kChunks * cs * sizeof(T)),
                  x + g * (int64_t)bs * m, x_bytes, full);
    }
    return;
  }

  const int group = warp / kWarps;     // the consumers
  int t = group;
  for (int64_t g = blockIdx.x + group * (int64_t)gridDim.x; g < nb;
       g += kGroups * (int64_t)gridDim.x, t += kGroups) {
    const int s = t % stages;
    mbar_wait(full0 + 8 * s, (uint32_t)(t / stages) & 1u);
    const T* sb = reinterpret_cast<const T*>(ring + (size_t)s * stage_bytes);
    const T* xg = kXStaged ? sb + (int64_t)kChunks * cs
                           : x + g * (int64_t)bs * m;
    T* yg = y + g * (int64_t)bs * m;
    if constexpr (sizeof(T) == 8)
      consume_mma<kPair, kXStaged>(sb, cs, xg, yg, bs, m, warp % kWarps,
                                   lane);
    else
      consume<T, kPair, kXStaged>(sb, cs, xg, yg, bs, m, warp % kWarps,
                                  lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }
}

// bytes of one stage: B_g's 8 padded chunks, then X_g on the bulk route,
// rounded up to 128
template <typename T>
int64_t stage_bytes(int bs, int m, bool x_staged) {
  const int64_t rows = (bs + kChunks - 1) / kChunks;
  const int64_t b =
      kChunks * (rows * bs * (int64_t)sizeof(T) + chunk_pad<T>());
  const int64_t xb = x_staged ? (int64_t)bs * m * (int64_t)sizeof(T) : 0;
  return (b + xb + 127) / 128 * 128;
}

template <typename T, bool kPair, bool kXStaged>
int launch_bulk(const T* b, const T* x, T* y, int64_t nb, int bs, int m,
                cudaStream_t s) {
  const int64_t stage = stage_bytes<T>(bs, m, kXStaged);
  const int stages =
      (int)std::min<int64_t>(kMaxStages, kRingBytes / stage) / kGroups *
      kGroups;
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const int shared = kBarrierBytes + stages * (int)stage;
  static bool opted_in = false;        // past 48 KB only after this
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        bulk_kernel<T, kPair, kXStaged>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        kBarrierBytes + kRingBytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)std::min<int64_t>(nb, sms);
  bulk_kernel<T, kPair, kXStaged><<<grid, kBulkThreads, shared, s>>>(
      b, x, y, nb, bs, m, stages, (int)stage);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bulk_route(const T* b, const T* x, T* y, int64_t nb, int bs,
                      int m, bool x_staged, cudaStream_t s) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(b) |
                        reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(y);
  if ((bs * sizeof(T)) % 16 || bs < kMinBulkRows || (any & 15))
    return (int)cudaErrorInvalidValue;
  const bool pair = m % 2 == 0;
  if (x_staged)
    return pair ? launch_bulk<T, true, true>(b, x, y, nb, bs, m, s)
                : launch_bulk<T, false, true>(b, x, y, nb, bs, m, s);
  return pair ? launch_bulk<T, true, false>(b, x, y, nb, bs, m, s)
              : launch_bulk<T, false, false>(b, x, y, nb, bs, m, s);
}

template <typename T>
int launch(const void* blocks, const void* x, void* y, int64_t nb, int bs,
           int m, int route, void* stream) {
  if (nb <= 0 || bs <= 0 || m <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* b = static_cast<const T*>(blocks);
  const T* xx = static_cast<const T*>(x);
  T* yy = static_cast<T*>(y);
  if (route == kBulk || route == kBulkXDirect)
    return launch_bulk_route<T>(b, xx, yy, nb, bs, m, route == kBulk, s);
  if (route != kRows) return (int)cudaErrorInvalidValue;
  const int tiles = (m + kTile - 1) / kTile;
  if (nb > 0x7fffffff || tiles > 65535)
    return (int)cudaErrorInvalidConfiguration;
  switch (group_width<T>(bs)) {
    case 1: launch_rows_width<T, 1>(b, xx, yy, nb, bs, m, tiles, s); break;
    case 2: launch_rows_width<T, 2>(b, xx, yy, nb, bs, m, tiles, s); break;
    case 4: launch_rows_width<T, 4>(b, xx, yy, nb, bs, m, tiles, s); break;
    default: launch_rows_width<T, 8>(b, xx, yy, nb, bs, m, tiles, s); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// blocks (nb, bs, bs) row-major; x and y (nb * bs, m) row-major; route 0
// rows, 1 bulk, 2 bulk_x_direct.  Returns the cudaError_t of the launch (0
// on success; cudaErrorInvalidValue for a route the operands do not meet).
extern "C" int repro_block_jacobi_apply_batched_f64(const void* blocks,
                                                    const void* x, void* y,
                                                    int64_t nb, int bs, int m,
                                                    int route, void* stream) {
  return launch<double>(blocks, x, y, nb, bs, m, route, stream);
}

extern "C" int repro_block_jacobi_apply_batched_f32(const void* blocks,
                                                    const void* x, void* y,
                                                    int64_t nb, int bs, int m,
                                                    int route, void* stream) {
  return launch<float>(blocks, x, y, nb, bs, m, route, stream);
}
