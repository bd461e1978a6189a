// grouped_mm_sm90: the grouped (ragged) matrix product of the dropless MoE
// dispatch, bf16 in, f32 sums, bf16 out, on Hopper's asynchronous
// tensor-core path (wgmma fed by a TMA ring)
//
//   y[r, :] = x[r, :] @ w[e]   for offsets[e] <= r < offsets[e + 1]
//
//   x (R, K) row-major, its rows sorted by expert; w (E, K, N) row-major
//   (N contiguous); offsets (E + 1,) int64 on the device, offsets[0] = 0,
//   offsets[E] = R, non-decreasing; y (R, N); K and N multiples of 8 and
//   16-byte aligned pointers (the launcher refuses anything else).
//
// The "wgmma" route of kernels/grouped_mm.py, every bf16 shape's (f32 and
// f64 take grouped_mm.cu's "mma" route).  It replaces no Pallas kernel: it
// stands in for jax.lax.ragged_dot, which the JAX package's sort dispatch
// (src/repro/models/moe.py _moe_sort) calls three times a layer.  The grid
// depends on (R, E, N) alone and each block finds its row tile in the
// offsets in device memory (grouped_tiles.cuh): no host read, one CUDA
// graph for every routing.
//
// What bounds it on an H100: bytes.  At deepseek-v3's prefill (R = 32,768
// rows over 256 experts, about 128 a group, `wi` K 7,168 x N 2,048) the
// launch must read all 7.5 GB of experts, x and write y: 8.09 GB, 2.415 ms
// at 3.35 TB/s, against 0.962 TFLOP, 0.97 ms at 989 TFLOP/s (about 119
// flop a byte, below the card's bf16 ridge of about 295).  At a decode
// step (R = 32) the weights of the experts hit, 0.26 ms.  An earlier design
// (warp-level mma.sync on 64 x 128 tiles fed by a three-stage cp.async
// ring) held near neither bound at the prefill (5.97 ms): its 64-row tiles
// read each expert's weight slab 2-3 times and x once per 128-column slab,
// about 26 GB from L2 into the SMs a launch.  So this route streams each
// expert's weights once and moves fewer bytes from L2:
//
// Design.  A block is one tile of kC x 64 rows of one expert by kBN
// columns: kC consumer warpgroups and one producer warpgroup, whose first
// thread keeps TMA loads in flight into a ring of kStages 64-deep stages
// (48 KB each, 193 KB of dynamic shared memory), completing on a "full"
// mbarrier per stage; each consumer warpgroup waits on it, issues four
// asynchronous wgmma m64n{kBN}k16 (bf16 -> f32, 64 x kBN accumulators in
// registers), keeps one group in flight and releases the stage before it
// on an "empty" mbarrier (one arrival a warp).  x is loaded with an L2
// evict-last hint (every column slab of the tile reads it again), w with
// evict-first (read once).  The outputs go out as bf16 pairs straight from
// the accumulators.  Two tiles (`grouped_mm.wgmma_tile`):
//   * 128 x 256 (kC = 2, 384 threads, 154 registers): a decode step's and
//     a small prefill's;
//   * 192 x 192 (kC = 3, 512 threads, 122 registers): from 64 rows a group,
//     where a 192-row tile holds nearly every group whole, so each weight
//     slab is read once, and x once per 192 columns: 13.9 GB from L2 at the
//     prefill, against 15.6 (128 x 256: half the groups spill into a
//     second tile that reads the slab again) and 26.0 (the mma.sync
//     design).
// The A/B (tools/grouped_ab.py, variants in turns within each of three
// calls, ms on an H100 80GB HBM3 at 700 W; `wi` / `wo`): at R = 32,768 the
// mma.sync design 5.969 / 6.203, 128 x 256 3.525 / 3.681, 192 x 192 2.870
// / 2.918, 192 x 128 2.865 / 3.283 (16.8 GB from L2; dropped),
// torch._grouped_mm 3.680 / 3.827; at R = 8,192 mma.sync 2.620 / 2.612,
// 128 x 256 2.452 / 2.521, 192 x 192 2.565 / 2.587; at R = 2,048 2.531 /
// 2.476, 2.369 / 2.420, 2.445 / 2.465; at R = 32 0.3129 / 0.3189, 0.2861 /
// 0.2846, 0.2883 / 0.2929; at R = 8 0.1524 / 0.0883, 0.0794 / 0.0833.
// This route led the mma.sync design at every R measured, so it replaced
// it for every bf16 shape; the tile crossover lies between 32 and 128 rows
// a group, set at 64.  A 192 x 256 tile (12.2 GB from L2) does not
// compile: 128 accumulators a thread at 512 threads exceed the 128
// registers __launch_bounds__ leaves, and setmaxnreg does not lift ptxas's
// cap.  K = 0 (an empty sum) writes zeros with one memset.
//
// Ragged rows.  x is a 2-D tensor map over (R, K), boxes of 64 rows x 64
// columns; a tile's rows start at offsets[e] + t BM, loaded in 64-row
// boxes, only as many as the tile has rows (a warpgroup with no rows skips
// the loop).  Rows past the expert's end belong to the next expert: loaded,
// summed, never stored (each output row depends on its own x row alone).
// Rows past R come back zero-filled by TMA's bounds.  w is a 3-D tensor
// map over (E, K, N), boxes of 64 K-rows x 64 columns of one expert, so a
// K that is not a multiple of 64 reads zeros past K, never the next
// expert's rows; a box wholly past N is not loaded, and the columns past N
// are never stored.  K and N are multiples of 8 (TMA's 16-byte strides).
//
// The operands in shared memory.  Both boxes are 128-byte rows swizzled
// by TMA's 128-byte pattern (16-byte chunk c of row r lands at c ^ (r &
// 7)), every box 1024-byte aligned.  A (x) is K-major: a descriptor of
// stride byte offset 1024 (the next 8 rows), the k-th 16-deep step 32
// bytes further along the row.  B (w, N contiguous) is MN-major, the
// transposed operand (imm-trans-b = 1): leading byte offset 8192 (the next
// 64-column box), stride byte offset 1024 (the next 8 K-rows), the k-th
// step 2048 bytes (16 K-rows) further.
//
// The tensor maps are encoded per call on the host by libcuda's
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (the
// library links the runtime alone), and passed by value as
// __grid_constant__ parameters, so a CUDA graph keeps them with its node.
// No atomics and no split-K: a repeat is bitwise equal.  A block past the
// last tile exits; an empty expert owns no tile and is never read.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grouped_tiles.cuh"
#include "mbarrier.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBK = 64;                 // depth of a stage: 128 bytes of bf16
constexpr int kGroupRows = 64;          // rows of a consumer warpgroup
constexpr int kBox = 64;                // a TMA box: 64 x 64 bf16
constexpr int kBoxBytes = kBox * kBK * 2;
constexpr int64_t kMaxTiles = 65535;    // the grid's y extent

// a tile of kC consumer warpgroups (64 rows each) by kBN columns, with a
// ring of kStages stages
template <int kC, int kBN, int kStages>
struct Tile {
  static constexpr int kBM = kC * kGroupRows;
  static constexpr int kThreads = 128 * (kC + 1);
  static constexpr int kABytes = kC * kBoxBytes;
  static constexpr int kBBytes = kBN / kBox * kBoxBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + align
};

// a shared-memory matrix descriptor of a 128-byte-swizzled operand
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// d (64 x N, f32, in the wgmma accumulator layout) += A B: A K-major, B
// MN-major (transposed), both 128-byte swizzled
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a,
                                      uint64_t b);

template <>
__device__ __forceinline__ void wgmma<192>(float (&d)[96], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<256>(float (&d)[128], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of the accumulators across the
// asynchronous products
template <int M>
__device__ __forceinline__ void fence_operands(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint64_t l2_policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_policy_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar,
                                            uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar),
      "l"(policy)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar,
                                            uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3, %4}], [%5], %6;\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar), "l"(policy)
      : "memory");
}

// a consumer warpgroup's products over the ring, then its 64 x kBN rows
// of y (rows past r1 and columns past N are not stored)
template <int kC, int kBN, int kStages>
__device__ __forceinline__ void consume(uint32_t ring, uint64_t* full,
                                        uint64_t* empty, bf16* y,
                                        int64_t r0, int64_t r1, int n0,
                                        int nk, int N, int wg, int warp,
                                        int lane) {
  using T = Tile<kC, kBN, kStages>;
  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    mbar_wait(smem_u32(&full[s]), (kt / kStages) & 1);
    const uint32_t a = ring + s * T::kStageBytes + wg * kBoxBytes;
    const uint32_t b = ring + s * T::kStageBytes + T::kABytes;
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma<kBN>(acc, smem_desc(a + 32 * kk, 16, 1024),
                 smem_desc(b + 2048 * kk, kBoxBytes, 1024));
    wgmma_commit();
    wgmma_wait<1>();                             // stage kt - 1 is read
    fence_operands(acc);
    if (kt > 0 && lane == 0)
      mbar_arrive(smem_u32(&empty[(kt - 1) % kStages]));
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // element 4 j + 2 h + i of the accumulators: row 16 (warp % 4) + lane / 4
  // + 8 h, column 8 j + 2 (lane % 4) + i of the warpgroup's 64 x kBN tile
  const int64_t row_a = r0 + wg * kGroupRows + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane & 3);
    if (col >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = row_a + 8 * h;
      if (row < r1)
        *reinterpret_cast<__nv_bfloat162*>(y + row * N + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

template <int kC, int kBN, int kStages>
__global__ void __launch_bounds__(Tile<kC, kBN, kStages>::kThreads, 1)
grouped_mm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap,
                        const int64_t* __restrict__ offsets,
                        bf16* __restrict__ y, int64_t R, int K, int N,
                        int E) {
  using T = Tile<kC, kBN, kStages>;
  extern __shared__ unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ int s_expert;
  __shared__ int64_t s_row0, s_row1;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // the tile's expert and rows, from the offsets in device memory
  if (warp == 0) {
    const RowTile tile = find_row_tile<T::kBM>(offsets, blockIdx.y, E, R);
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
  const int64_t r1 = s_row1;
  const int groups = (int)((r1 - r0 + kGroupRows - 1) / kGroupRows);
  const int n0 = blockIdx.x * kBN;
  const int nk = (K + kBK - 1) / kBK;
  const uint32_t ring = (smem_u32(smem) + 1023u) & ~1023u;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 4 * groups);  // each active warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == kC) {                                // the producer
    if (tid == 128 * kC) {
      const uint64_t keep = l2_policy_evict_last();    // x: every slab's
      const uint64_t once = l2_policy_evict_first();   // w: read once
      const int boxes = min(kBN / kBox, (N - n0 + kBox - 1) / kBox);
      const uint32_t bytes = (uint32_t)(groups + boxes) * kBoxBytes;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        // round 0 passes at once (the phase before counts as complete)
        mbar_wait(smem_u32(&empty[s]), ((kt / kStages) & 1) ^ 1);
        const uint32_t bar = smem_u32(&full[s]);
        mbar_arrive_expect_tx(bar, bytes);
        const uint32_t a = ring + s * T::kStageBytes;
        for (int g = 0; g < groups; ++g)
          tma_load_2d(a + g * kBoxBytes, &xmap, kt * kBK,
                      (int)(r0 + g * kGroupRows), bar, keep);
        const uint32_t b = a + T::kABytes;
        for (int j = 0; j < boxes; ++j)
          tma_load_3d(b + j * kBoxBytes, &wmap, n0 + j * kBox, kt * kBK, e,
                      bar, once);
      }
    }
  } else if (wg < groups) {     // a consumer: rows r0 + 64 wg .. + 63
    consume<kC, kBN, kStages>(ring, full, empty, y, r0, r1, n0, nk, N, wg,
                              warp, lane);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, or null
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a bf16 tensor map of `rank` dims (innermost first), boxes of 64 x 64 (x
// 1), 128-byte swizzle, zeros out of bounds
bool encode(CUtensorMap* map, const void* base, int rank,
            const cuuint64_t* dims, const cuuint64_t* strides) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t box[3] = {kBox, kBox, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
            const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kC, int kBN, int kStages>
int launch(const void* x, const void* w, const void* offsets, void* y,
           int64_t R, int K, int N, int E, cudaStream_t stream) {
  using T = Tile<kC, kBN, kStages>;
  const int64_t tiles = max_row_tiles<T::kBM>(R, E);
  if (tiles > kMaxTiles) return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {(cuuint64_t)K, (cuuint64_t)R};
  const cuuint64_t xstrides[1] = {(cuuint64_t)K * 2};
  const cuuint64_t wdims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t wstrides[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
  if (!encode(&xmap, x, 2, xdims, xstrides) ||
      !encode(&wmap, w, 3, wdims, wstrides))
    return (int)cudaErrorNotSupported;
  static const cudaError_t opted = cudaFuncSetAttribute(
      grouped_mm_wgmma_kernel<kC, kBN, kStages>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (opted != cudaSuccess) return (int)opted;
  const dim3 grid((N + kBN - 1) / kBN, (unsigned)tiles);
  grouped_mm_wgmma_kernel<kC, kBN, kStages>
      <<<grid, T::kThreads, T::kSmemBytes, stream>>>(
          xmap, wmap, static_cast<const int64_t*>(offsets),
          static_cast<bf16*>(y), R, K, N, E);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x (R, K), w (E, K, N), y (R, N): device pointers to bf16; offsets: a
// device pointer to E + 1 int64; tile: the tile variant (0: 128 x 256, 1:
// 192 x 192).  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int repro_grouped_wgmma_bf16(const void* x, const void* w,
                                        const void* offsets, void* y,
                                        int64_t R, int K, int N, int E,
                                        int tile, void* stream) {
  if (R <= 0 || N <= 0) return 0;
  if (K < 0 || E <= 0 || K % 8 != 0 || N % 8 != 0 || !aligned16(x) ||
      !aligned16(w) || !aligned16(y))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K == 0)            // an empty sum: zeros (a tensor map has no K = 0)
    return (int)cudaMemsetAsync(y, 0, (size_t)R * N * sizeof(bf16), s);
  switch (tile) {
    case 0: return launch<2, 256, 4>(x, w, offsets, y, R, K, N, E, s);
    case 1: return launch<3, 192, 4>(x, w, offsets, y, R, K, N, E, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
