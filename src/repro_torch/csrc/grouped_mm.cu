// grouped_mm: the grouped (ragged) matrix product of the dropless MoE
// dispatch, bf16 in, f32 sums, bf16 out, on the tensor cores
//
//   y[r, :] = x[r, :] @ w[e]   for offsets[e] <= r < offsets[e + 1]
//
//   x (R, K) row-major, its rows sorted by expert; w (E, K, N) row-major
//   (N contiguous); offsets (E + 1,) int64 on the device, offsets[0] = 0,
//   offsets[E] = R, non-decreasing; y (R, N).  K and N multiples of 8 and
//   16-byte aligned pointers (the launcher refuses anything else).
//
// Replaces no Pallas kernel.  It stands in for jax.lax.ragged_dot, which
// the JAX package's sort dispatch (src/repro/models/moe.py _moe_sort) calls
// three times a layer and XLA lowers on its own.  The port needs it by hand
// because the group sizes live on the device: a loop over the experts would
// read them to the host every call, and a step with such a read cannot be
// captured as a CUDA graph.  Nothing about the routing is a launch
// argument: the grid depends on (R, E, N) alone, so one graph serves every
// routing, and each block finds its group in the offsets in device memory.
//
// What bounds it on an H100.  Decode (R = 32 rows of a 4-token step at
// top-8): bytes, the weights of the experts hit (about 31 of deepseek-v3's
// 256, 0.91 GB a launch at K = 7,168, N = 2,048: 0.27 ms at 3.35 TB/s); an
// expert no row chose is read by no block.  Prefill (R = 32,768): at
// deepseek's widths the weights of all 256 experts (7.5 GB, 2.2 ms) weigh
// more than the 0.96 TFLOP (0.97 ms at 989 TFLOP/s).  This design is
// right first: warp-level mma.sync m16n8k16 (bf16 -> f32) fed by
// ldmatrix from a three-stage cp.async ring of 16-byte copies; wgmma and
// TMA, which the tensor cores' full rate needs, are later work.
//
// Design.  Row tiles of BM = 64 rows never straddle two experts: expert e
// has ceil(size_e / BM) of them, and their number is at most ceil(R / BM)
// + min(E, R), the grid's y extent (65,535 at most: R up to about 4 M);
// x runs over the BN = 128-column slabs of N, so the blocks of one row
// tile run side by side and read its rows from L2 after the first (with
// the row tile outermost instead, each slab's block found them evicted
// and the prefill's products took 7.4 ms, not 5.7, on an H100).  Warp 0 of
// each block maps its tile index to (expert, first row): each lane sums the tile counts of E / 32 consecutive experts from
// the offsets, a warp scan gives each lane its first tile, and the lane
// whose range holds the index walks its experts to find it.  A block past
// the last tile exits; an empty expert owns no tile, so its weights are
// never loaded.  Rows past the expert's end are zero-filled in shared
// memory (cp.async with a source size of 0 reads nothing) and never
// stored.  Four warps, 2 x 2, each own a 32 x 64 slab of the 64 x 128
// output tile: two A fragments (ldmatrix.x4) and eight B fragments
// (ldmatrix.x4.trans, w being K-major) per 16-deep k-step, 16 mma.sync, 64
// f32 accumulators a thread.  Shared-memory rows are padded by 8 bf16, so
// the 8 rows an ldmatrix reads fall in distinct banks.  The stages are 13.5
// KB; three fit in the 48 KB a block gets without opting in.  No atomics:
// a repeat is bitwise equal.

#include "mma_bf16.cuh"

namespace {

constexpr int kBM = 64;          // rows of a tile (one expert's)
constexpr int kBN = 128;         // columns of a tile
constexpr int kBK = 32;          // depth of a stage
constexpr int kStages = 3;
constexpr int kWarps = 4;        // 2 x 2, each 32 x 64
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;          // bf16 of padding per shared-memory row
constexpr int kAStride = kBK + kPad;
constexpr int kBStride = kBN + kPad;
constexpr int kAElems = kBM * kAStride;
constexpr int kBElems = kBK * kBStride;
constexpr int64_t kMaxTiles = 65535;   // the grid's y extent

// wait until at most kStages - 2 committed groups are still in flight
__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int tiles_of(const int64_t* __restrict__ offsets,
                                        int e) {
  const int64_t size = offsets[e + 1] - offsets[e];
  return size > 0 ? (int)((size + kBM - 1) / kBM) : 0;
}

// stage kt of the x rows [r0, r1) and of w[e]'s columns n0 .. n0 + kBN - 1
__device__ __forceinline__ void load_stage(bf16* as, bf16* bs,
                                           const bf16* __restrict__ x,
                                           const bf16* __restrict__ we,
                                           int64_t r0, int64_t r1, int n0,
                                           int kt, int K, int N, int tid) {
  const int k0 = kt * kBK;
  constexpr int kAChunks = kBK / 8;            // 16-byte chunks a row
#pragma unroll
  for (int c = tid; c < kBM * kAChunks; c += kThreads) {
    const int r = c / kAChunks;
    const int kc = (c - r * kAChunks) * 8;
    const int64_t row = r0 + r;
    const bool in = row < r1 && k0 + kc < K;
    const bf16* g = in ? x + row * K + k0 + kc : x;
    cp_async16(smem_addr(as + r * kAStride + kc), g, in ? 16 : 0);
  }
  constexpr int kBChunks = kBN / 8;
#pragma unroll
  for (int c = tid; c < kBK * kBChunks; c += kThreads) {
    const int r = c / kBChunks;
    const int nc = (c - r * kBChunks) * 8;
    const int kk = k0 + r;
    const int col = n0 + nc;
    const bool in = kk < K && col < N;
    const bf16* g = in ? we + (int64_t)kk * N + col : we;
    cp_async16(smem_addr(bs + r * kBStride + nc), g, in ? 16 : 0);
  }
}

__global__ void __launch_bounds__(kThreads, 4)
grouped_mm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const int64_t* __restrict__ offsets, bf16* __restrict__ y,
                  int64_t R, int K, int N, int E) {
  __shared__ __align__(16) bf16 as[kStages * kAElems];
  __shared__ __align__(16) bf16 bs[kStages * kBElems];
  __shared__ int s_expert;
  __shared__ int64_t s_row0, s_row1;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // the tile's expert and rows, from the offsets in device memory
  if (warp == 0) {
    const int t = blockIdx.y;
    const int per = (E + 31) / 32;
    const int lo = min(lane * per, E);
    const int hi = min(lo + per, E);
    int count = 0;
    for (int e = lo; e < hi; ++e) count += tiles_of(offsets, e);
    int incl = count;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 0) s_expert = -1;
    __syncwarp();
    if (t >= incl - count && t < incl) {         // one lane at most
      int first = incl - count;
      for (int e = lo; e < hi; ++e) {
        const int n = tiles_of(offsets, e);
        if (t < first + n) {
          const int64_t row0 = offsets[e] + (int64_t)(t - first) * kBM;
          s_expert = e;
          s_row0 = row0;
          s_row1 = min64(min64(offsets[e + 1], row0 + kBM), R);
          break;
        }
        first += n;
      }
    }
  }
  __syncthreads();
  const int e = s_expert;
  if (e < 0) return;                             // past the last tile
  const int64_t r0 = s_row0;
  const int64_t r1 = s_row1;
  const int n0 = blockIdx.x * kBN;
  const bf16* we = w + (int64_t)e * K * N;

  const int wm = warp >> 1;                      // rows 32 wm .. + 31
  const int wn = warp & 1;                       // columns 64 wn .. + 63
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int nk = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_stage(as + s * kAElems, bs + s * kBElems, x, we, r0, r1, n0, s, K,
                 N, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait_stage();                       // stage kt has landed
    __syncthreads();                             // and stage kt - 1 is free
    const int pre = kt + kStages - 1;
    if (pre < nk) {
      const int s = pre % kStages;
      load_stage(as + s * kAElems, bs + s * kBElems, x, we, r0, r1, n0, pre,
                 K, N, tid);
    }
    cp_async_commit();                           // empty near the end
    const bf16* at = as + (kt % kStages) * kAElems;
    const bf16* bt = bs + (kt % kStages) * kBElems;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // matrix i of the x4 load: rows 8 (i & 1) .. + 7, columns
      // 8 (i >> 1) .. + 7 of a 16 x 16 block
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(af[mt], smem_addr(at + (wm * 32 + mt * 16 + (lane & 15)) *
                                               kAStride +
                                           kk * 16 + (lane >> 4) * 8));
      // matrix i of the transposed x4 load: k rows 8 (i & 1) .. + 7,
      // columns 8 (i >> 1) .. + 7 of a 16-column pair of n-tiles
#pragma unroll
      for (int jd = 0; jd < 4; ++jd) {
        uint32_t r[4];
        ldmatrix_x4_trans(
            r, smem_addr(bt +
                         (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                             kBStride +
                         wn * 64 + jd * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * jd], af[mt], r[0], r[1]);
          mma_bf16(acc[mt][2 * jd + 1], af[mt], r[2], r[3]);
        }
      }
    }
  }

  // element q of an accumulator: row g + 8 (q >> 1), column 2 (lane & 3)
  // + (q & 1) of its 16 x 8 tile
  const int g = lane >> 2;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + wn * 64 + j * 8 + 2 * (lane & 3);
      if (col >= N) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int64_t row = r0 + wm * 32 + mt * 16 + g + 8 * i;
        if (row >= r1) continue;
        *reinterpret_cast<__nv_bfloat162*>(y + row * N + col) =
            __floats2bfloat162_rn(acc[mt][j][2 * i], acc[mt][j][2 * i + 1]);
      }
    }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x (R, K), w (E, K, N), y (R, N): device pointers to bf16; offsets: a
// device pointer to E + 1 int64.  Returns the cudaError_t of the launch (0
// on success).
extern "C" int repro_grouped_mm_bf16(const void* x, const void* w,
                                     const void* offsets, void* y, int64_t R,
                                     int K, int N, int E, void* stream) {
  if (R <= 0 || N <= 0) return 0;
  const int64_t tiles = (R + kBM - 1) / kBM + (E < R ? E : R);
  if (K < 0 || E <= 0 || K % 8 != 0 || N % 8 != 0 || !aligned16(x) ||
      !aligned16(w) || !aligned16(y) || tiles > kMaxTiles)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (unsigned)tiles);
  grouped_mm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const int64_t*>(offsets), static_cast<bf16*>(y), R, K, N,
      E);
  return (int)cudaGetLastError();
}
