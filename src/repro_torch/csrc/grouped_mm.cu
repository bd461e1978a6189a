// grouped_mm: the grouped (ragged) matrix product of the dropless MoE
// dispatch in f32 and f64 on the tensor cores (the "mma" route; bf16 goes
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
// a prefill's R = 32,768 rows (about 128 a group): the products, 0.962
// TFLOP, 5.83 ms for three TF32 passes at 495 TFLOP/s (f32) and 14.36 ms
// at the fp64 tensor cores' 67 TFLOP/s (f64), against 16.2 / 32.4 GB of
// bytes, 4.8 / 9.7 ms: operations.  At a decode step's R = 32 (about 31 of
// 256 experts hit, one row each) the hit experts' weights, 1.6 / 3.3 GB,
// 0.49 / 0.98 ms: bytes.  The FMA design before this one (64 x 64 tiles on
// the CUDA cores, loaded element by element between two barriers) reached
// neither: its CUDA-core ceiling alone is 14.36 ms in f32.  This one reads
// (chip_smoke.py 4d on an H100 80GB HBM3 at 700 W, PERF.md row 12b) 19.13
// ms in f32 at that prefill shape, under torch._grouped_mm's 28.56 in the
// same run (28.5006 in an earlier one), and 27.90 in f64, above the plain
// per-expert loop's 26.01; 0.598 / 1.096 ms at the decode step's; the FMA
// design 56.93 / 82.49 and 2.81 / 3.65.
//
// The products.  f32: 3xTF32 on mma.sync m16n8k8 (mma_fp32_fp64.cuh):
// each operand split into TF32 hi + lo (split_3xtf32 below), lo_a hi_b +
// hi_a lo_b + hi_a hi_b, about 21 bits a product (one TF32 pass keeps 10
// and misses the plain version's f32 sums).  Not wgmma: its TF32 operands
// must be K-major, and w (N contiguous) is MN-major.  The tensor cores
// truncate each sum to f32, so over K = 7,168 one accumulator would take
// 2,688 truncations, each biased toward zero; each stage's products (4
// k-steps, 12 sums) go into accumulators of their own, joined to the
// running sum by one rounded add, as the fp32 flash kernel joins each key
// tile.  f64: mma.sync m16n8k16 (the fp64 tensor cores; wgmma has no f64
// form), one accumulator.
//
// Design.  A block is one tile of BM rows of one expert by BN = 128
// columns, found from the offsets by its first warp.  A ring of kStages
// stages in dynamic shared memory (128 bytes of K a row: 32 f32 or 16 f64)
// is filled by cp.async, kStages - 1 stages in flight while the warps work
// on one, one __syncthreads a stage.  Rows past the tile's end are not
// loaded (each output row reads its own x row alone, and is not stored),
// columns of w past N neither; the depth past K is zero-filled in both
// operands.  Row strides make every fragment load conflict-free: x's
// stage rows are 36 f32 (4 mod 32 banks) or 20 f64 (4 mod 16 8-byte
// banks), w's BN + 8 f32 (8 mod 32) or BN + 4 f64 (4 mod 16).  The warps
// split into WM row groups by 4 column groups; a warp's 16-row m-tiles are
// interleaved with the other row groups' (m-tile i belongs to row group i
// mod WM), so a ragged tile spreads its rows over every warp, and an
// m-tile wholly past the tile's rows is skipped; a full tile runs an
// instance with no such test, so its loop has no branch.  Two tiles,
// chosen by kernels/grouped_mm.mma_tile from R and E alone:
//   * "64x128" (8 warps, 2 x 4, two blocks an SM): while groups average
//     fewer than TALL_TILE_ROWS_PER_GROUP rows, the launch streams the
//     hit experts' weights, 16 warps and 6 stages of copies an SM;
//   * "144x128" (12 warps, 3 x 4, one block an SM): from there, a tile
//     holds nearly every group of about 128 rows whole (a 128-row tile
//     leaves half of them a second tile of a few rows, which streams the
//     weight slab again), and the twelve warps keep three a scheduler.
// In turns on an H100 they led 32- and 128-row tiles of 4 and 8 warps, a
// 160-row tile of 8 warps and 16 warps on 128 rows at deepseek's shapes;
// the branch-free full tile and split_3xtf32 each gained a few percent
// (PERF.md row 12b; tools/grouped_ab.py times the two tiles kept).  What
// holds the tall tile back is not the tensor cores' rate (mma.sync alone
// runs f64 at 65.9-67.9 TFLOP/s, the card's 67, and TF32 at up to 323,
// tools/mma_rate.py on an H100 at 700 W): by the code's count f32 issues
// more than two other instructions (its fragment loads and splits) for
// each mma.sync, and both dtypes read each tile's rows of x and slab of w
// from L2 once per 128 columns and per tile.
// VEC (chosen by the launcher's caller: K and N multiples of 16 bytes'
// elements and 16-byte aligned pointers) copies 16 bytes at a time; else
// one element (cp.async of 4 or 8 bytes) into the same layout, so any K and
// N are taken.  No atomics and no split-K: a repeat is bitwise equal.  A
// block past the last tile exits; K = 0 writes zeros.

#include "grouped_tiles.cuh"
#include "mma_fp32_fp64.cuh"

namespace {

constexpr int64_t kMaxTiles = 65535;   // the grid's y extent
constexpr int kBN = 128;               // columns of a tile
constexpr int kStages = 4;

template <typename T>
struct Traits;

template <>
struct Traits<float> {
  static constexpr int kK = 8;       // depth of one mma.sync (TF32)
  static constexpr int kBK = 32;     // depth of a stage: 128-byte rows
  static constexpr int kPadA = 4;    // x rows of 36 floats: 4 mod 32 banks
  static constexpr int kPadB = 8;    // w rows of BN + 8: 8 mod 32
};

template <>
struct Traits<double> {
  static constexpr int kK = 16;      // depth of one mma.sync (f64)
  static constexpr int kBK = 16;
  static constexpr int kPadA = 4;    // 20 doubles: 4 mod 16 8-byte banks
  static constexpr int kPadB = 4;    // BN + 4: 4 mod 16
};

// a tile of BM rows by kBN columns over WM x WN warps, MIN_BLOCKS an SM
template <typename T, int BM, int WM, int WN, int MIN_BLOCKS>
struct Tile {
  using Tr = Traits<T>;
  static constexpr int kBM = BM;
  static constexpr int kWM = WM;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kMinBlocks = MIN_BLOCKS;
  static constexpr int kSA = Tr::kBK + Tr::kPadA;   // row strides, elements
  static constexpr int kSB = kBN + Tr::kPadB;
  static constexpr int kAElems = BM * kSA;
  static constexpr int kStageElems = kAElems + Tr::kBK * kSB;
  static constexpr int kSmemBytes = kStages * kStageElems * (int)sizeof(T);
  static constexpr int kMT = BM / 16 / WM;          // m-tiles a warp
  static constexpr int kWN = kBN / WN;              // columns a warp
  static constexpr int kNT = kWN / 8;               // n-tiles a warp
};

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(double* p, double a, double b) {
  *reinterpret_cast<double2*>(p) = make_double2(a, b);
}

template <typename T, bool VEC>
__device__ __forceinline__ void copy_in(T* dst, const T* src, bool in) {
  if (VEC)
    cp_async16(smem_addr(dst), src, in ? 16 : 0);
  else
    cp_async_elem<sizeof(T)>(smem_addr(dst), src, in ? (int)sizeof(T) : 0);
}

// stage k0 .. k0 + kBK of the ring: the tile's rows of x (xr: its first
// row) into sa, w[e]'s rows (we: w[e]) at columns n0 .. n0 + kBN into sb
template <typename T, class C, bool VEC>
__device__ __forceinline__ void load_stage(T* sa, T* sb,
                                           const T* __restrict__ xr,
                                           const T* __restrict__ we,
                                           int rows, int K, int N, int k0,
                                           int n0, int tid) {
  constexpr int kBK = Traits<T>::kBK;
  constexpr int V = VEC ? 16 / (int)sizeof(T) : 1;
  constexpr int kAChunks = kBK / V;                 // a row's copies
  for (int c = tid; c < C::kBM * kAChunks; c += C::kThreads) {
    const int r = c / kAChunks;
    if (r >= rows) break;                           // past the tile's end
    const int k = (c - r * kAChunks) * V;
    const bool in = k0 + k < K;
    copy_in<T, VEC>(sa + r * C::kSA + k,
                    in ? xr + (int64_t)r * K + k0 + k : xr, in);
  }
  constexpr int kBChunks = kBN / V;
  for (int c = tid; c < kBK * kBChunks; c += C::kThreads) {
    const int k = c / kBChunks;
    const int n = (c - k * kBChunks) * V;
    if (n0 + n >= N) continue;                      // never stored
    const bool in = k0 + k < K;
    copy_in<T, VEC>(sb + k * C::kSB + n,
                    in ? we + (int64_t)(k0 + k) * N + n0 + n : we, in);
  }
}

// first row (in the tile) of a warp's m-tile i
template <class C>
__device__ __forceinline__ int mtile_row(int i, int wm) {
  return (i * C::kWM + wm) * 16;
}

// x = hi + lo for a 3xTF32 product in three instructions, where
// split_tf32 (mma_fp32_fp64.cuh) takes five: mma.sync reads the top 19
// bits of a TF32 operand and ignores the low 13, so hi may carry x's bits
// plus half a TF32 unit (read as tf32_rna(x)), and lo = x - tf32_rna(x),
// exact in f32, is passed as it is (read truncated to 10 mantissa bits,
// at most 2^-21 of x off, where split_tf32's rounded lo is 2^-22)
__device__ __forceinline__ void split_3xtf32(float x, uint32_t& hi,
                                             uint32_t& lo) {
  hi = __float_as_uint(x) + 0x1000u;
  lo = __float_as_uint(x - __uint_as_float(hi & 0xFFFFE000u));
}

// one stage's products in f32: 3xTF32 into fresh accumulators, joined to
// acc by one rounded add each
template <class C, bool FULL>
__device__ __forceinline__ void stage_products(
    const float* __restrict__ sa, const float* __restrict__ sb,
    float (&acc)[C::kMT][C::kNT][4], int rows, int wm, int col0, int g,
    int t) {
  float st[C::kMT][C::kNT][4];
#pragma unroll
  for (int i = 0; i < C::kMT; ++i)
#pragma unroll
    for (int j = 0; j < C::kNT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) st[i][j][v] = 0.f;
#pragma unroll
  for (int ks = 0; ks < Traits<float>::kBK; ks += Traits<float>::kK) {
    uint32_t bh[C::kNT][2], bl[C::kNT][2];
#pragma unroll
    for (int j = 0; j < C::kNT; ++j)
#pragma unroll
      for (int v = 0; v < 2; ++v)
        split_3xtf32(sb[(ks + t + 4 * v) * C::kSB + col0 + 8 * j + g],
                     bh[j][v], bl[j][v]);
#pragma unroll
    for (int i = 0; i < C::kMT; ++i) {
      const int m0 = mtile_row<C>(i, wm);
      if (!FULL && m0 >= rows) break;
      uint32_t ah[4], al[4];
#pragma unroll
      for (int v = 0; v < 4; ++v)
        split_3xtf32(
            sa[(m0 + g + 8 * (v & 1)) * C::kSA + ks + t + 4 * (v >> 1)],
            ah[v], al[v]);
#pragma unroll
      for (int j = 0; j < C::kNT; ++j)
        mma_3xtf32(st[i][j], ah, al, bh[j][0], bh[j][1], bl[j][0], bl[j][1]);
    }
  }
#pragma unroll
  for (int i = 0; i < C::kMT; ++i)
#pragma unroll
    for (int j = 0; j < C::kNT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] += st[i][j][v];
}

// one stage's products in f64 on the fp64 tensor cores, into acc
template <class C, bool FULL>
__device__ __forceinline__ void stage_products(
    const double* __restrict__ sa, const double* __restrict__ sb,
    double (&acc)[C::kMT][C::kNT][4], int rows, int wm, int col0, int g,
    int t) {
#pragma unroll
  for (int ks = 0; ks < Traits<double>::kBK; ks += Traits<double>::kK) {
    double b[C::kNT][4];
#pragma unroll
    for (int j = 0; j < C::kNT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        b[j][v] = sb[(ks + t + 4 * v) * C::kSB + col0 + 8 * j + g];
#pragma unroll
    for (int i = 0; i < C::kMT; ++i) {
      const int m0 = mtile_row<C>(i, wm);
      if (!FULL && m0 >= rows) break;
      double a[8];
#pragma unroll
      for (int v = 0; v < 8; ++v)
        a[v] = sa[(m0 + g + 8 * (v & 1)) * C::kSA + ks + t + 4 * (v >> 1)];
#pragma unroll
      for (int j = 0; j < C::kNT; ++j) dmma(acc[i][j], a, b[j]);
    }
  }
}

template <typename T, class C, bool VEC, bool FULL>
__device__ __forceinline__ void run_tile(const T* __restrict__ xr,
                                         const T* __restrict__ we,
                                         T* __restrict__ y, int64_t r0,
                                         int rows, int K, int N, T* smem) {
  constexpr int kBK = Traits<T>::kBK;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n0 = blockIdx.x * kBN;
  const int nk = (K + kBK - 1) / kBK;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) {
      T* sa = smem + s * C::kStageElems;
      load_stage<T, C, VEC>(sa, sa + C::kAElems, xr, we, rows, K, N, s * kBK,
                            n0, tid);
    }
    cp_async_commit();
  }

  const int wm = warp % C::kWM;
  const int col0 = (warp / C::kWM) * C::kWN;     // the warp's first column
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool busy = mtile_row<C>(0, wm) < rows;  // the warp has rows
  T acc[C::kMT][C::kNT][4];
#pragma unroll
  for (int i = 0; i < C::kMT; ++i)
#pragma unroll
    for (int j = 0; j < C::kNT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = T(0);

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();                // stage kt has landed
    __syncthreads();                             // and stage kt - 1 is read
    const int kn = kt + kStages - 1;
    if (kn < nk) {
      T* sa = smem + (kn % kStages) * C::kStageElems;
      load_stage<T, C, VEC>(sa, sa + C::kAElems, xr, we, rows, K, N,
                            kn * kBK, n0, tid);
    }
    cp_async_commit();                           // empty past the last
    if (busy) {
      const T* sa = smem + (kt % kStages) * C::kStageElems;
      stage_products<C, FULL>(sa, sa + C::kAElems, acc, rows, wm, col0, g, t);
    }
  }

  // acc[i][j]: rows m0 + g and m0 + g + 8, columns 2 t and 2 t + 1 of
  // n-tile j
#pragma unroll
  for (int i = 0; i < C::kMT; ++i) {
    const int m0 = mtile_row<C>(i, wm);
    if (m0 >= rows) break;
#pragma unroll
    for (int j = 0; j < C::kNT; ++j) {
      const int col = n0 + col0 + 8 * j + 2 * t;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + g + 8 * h;
        if (m >= rows) continue;
        T* dst = y + (r0 + m) * N + col;
        if (VEC) {        // N even, col even: the pair lies inside the row
          store_pair(dst, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          dst[0] = acc[i][j][2 * h];
          if (col + 1 < N) dst[1] = acc[i][j][2 * h + 1];
        }
      }
    }
  }
}

template <typename T, class C, bool VEC>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks)
grouped_mm_mma_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const int64_t* __restrict__ offsets, T* __restrict__ y,
                      int64_t R, int K, int N, int E) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  __shared__ int s_expert;
  __shared__ int64_t s_row0, s_row1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp == 0) {
    const RowTile tile = find_row_tile<C::kBM>(offsets, blockIdx.y, E, R);
    if (lane == 0) {
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
  const T* xr = x + r0 * K;
  const T* we = w + (int64_t)e * K * N;
  if (rows == C::kBM)                            // no m-tile to skip
    run_tile<T, C, VEC, true>(xr, we, y, r0, rows, K, N, smem);
  else
    run_tile<T, C, VEC, false>(xr, we, y, r0, rows, K, N, smem);
}

template <typename T, class C, bool VEC>
int launch(const void* x, const void* w, const void* offsets, void* y,
           int64_t R, int K, int N, int E, cudaStream_t stream) {
  const int64_t tiles = max_row_tiles<C::kBM>(R, E);
  if (tiles > kMaxTiles) return (int)cudaErrorInvalidValue;
  static const cudaError_t opted = cudaFuncSetAttribute(
      grouped_mm_mma_kernel<T, C, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (opted != cudaSuccess) return (int)opted;
  const dim3 grid((N + kBN - 1) / kBN, (unsigned)tiles);
  grouped_mm_mma_kernel<T, C, VEC><<<grid, C::kThreads, C::kSmemBytes,
                                     stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int64_t*>(offsets), static_cast<T*>(y), R, K, N, E);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int launch_mma(const void* x, const void* w, const void* offsets, void* y,
               int64_t R, int K, int N, int E, int tile, int vec,
               void* stream) {
  if (R <= 0 || N <= 0) return 0;
  constexpr int V = 16 / (int)sizeof(T);
  if (K < 0 || E <= 0 || tile < 0 || tile > 1 ||
      (vec && (K % V != 0 || N % V != 0 || !aligned16(x) || !aligned16(w) ||
               !aligned16(y))))
    return (int)cudaErrorInvalidValue;
  using Short = Tile<T, 64, 2, 4, 2>;
  using Tall = Tile<T, 144, 3, 4, 1>;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 0)
    return vec ? launch<T, Short, true>(x, w, offsets, y, R, K, N, E, s)
               : launch<T, Short, false>(x, w, offsets, y, R, K, N, E, s);
  return vec ? launch<T, Tall, true>(x, w, offsets, y, R, K, N, E, s)
             : launch<T, Tall, false>(x, w, offsets, y, R, K, N, E, s);
}

}  // namespace

// x (R, K), w (E, K, N), y (R, N): device pointers to float (f32) or
// double (f64); offsets: a device pointer to E + 1 int64; tile: 0 for
// 64 x 128, 1 for 144 x 128; vec: 1 for 16-byte copies (K and N multiples
// of 16 bytes' elements, 16-byte aligned pointers, else refused), 0 for
// element copies (any K and N).  Returns the cudaError_t of the launch (0
// on success).
extern "C" int repro_grouped_mm_f32(const void* x, const void* w,
                                    const void* offsets, void* y, int64_t R,
                                    int K, int N, int E, int tile, int vec,
                                    void* stream) {
  return launch_mma<float>(x, w, offsets, y, R, K, N, E, tile, vec, stream);
}

extern "C" int repro_grouped_mm_f64(const void* x, const void* w,
                                    const void* offsets, void* y, int64_t R,
                                    int K, int N, int E, int tile, int vec,
                                    void* stream) {
  return launch_mma<double>(x, w, offsets, y, R, K, N, E, tile, vec, stream);
}
