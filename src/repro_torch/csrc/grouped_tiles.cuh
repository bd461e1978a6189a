// The row tiles of the grouped product (grouped_mm.cu, grouped_mm_sm90.cu):
// expert e's rows offsets[e] .. offsets[e + 1] - 1 fall into ceil(size_e /
// BM) tiles of at most BM rows, which never straddle two experts; an empty
// expert owns none.  Any routing of R rows over E experts has at most
// ceil(R / BM) + min(E, R) tiles, so a grid of that many tile rows serves
// every routing, and each block finds its tile from the offsets in device
// memory: no host read, one CUDA graph for any routing.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct RowTile {
  int expert;      // -1: the block is past the last tile
  int64_t row0;    // first row of the tile
  int64_t row1;    // one past its last row
};

template <int BM>
__device__ __forceinline__ int tiles_of(const int64_t* __restrict__ offsets,
                                        int e) {
  const int64_t size = offsets[e + 1] - offsets[e];
  return size > 0 ? (int)((size + BM - 1) / BM) : 0;
}

// Run by one whole warp: tile t's expert and rows.  Each lane sums the tile
// counts of E / 32 consecutive experts, a warp scan gives each lane its
// first tile, and the lane whose range holds t walks its experts to find
// it; the result is broadcast to the warp.
template <int BM>
__device__ RowTile find_row_tile(const int64_t* __restrict__ offsets, int t,
                                 int E, int64_t R) {
  const int lane = threadIdx.x & 31;
  const int per = (E + 31) / 32;
  const int lo = min(lane * per, E);
  const int hi = min(lo + per, E);
  int count = 0;
  for (int e = lo; e < hi; ++e) count += tiles_of<BM>(offsets, e);
  int incl = count;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  RowTile tile{-1, 0, 0};
  const bool mine = t >= incl - count && t < incl;   // one lane at most
  if (mine) {
    int first = incl - count;
    for (int e = lo; e < hi; ++e) {
      const int n = tiles_of<BM>(offsets, e);
      if (t < first + n) {
        const int64_t row0 = offsets[e] + (int64_t)(t - first) * BM;
        int64_t row1 = offsets[e + 1] < row0 + BM ? offsets[e + 1]
                                                  : row0 + BM;
        tile = RowTile{e, row0, row1 < R ? row1 : R};
        break;
      }
      first += n;
    }
  }
  const unsigned owner = __ballot_sync(0xffffffffu, mine);
  if (owner == 0) return RowTile{-1, 0, 0};
  const int src = __ffs(owner) - 1;
  tile.expert = __shfl_sync(0xffffffffu, tile.expert, src);
  tile.row0 = __shfl_sync(0xffffffffu, tile.row0, src);
  tile.row1 = __shfl_sync(0xffffffffu, tile.row1, src);
  return tile;
}

// the grid's tile extent for R rows over E experts
template <int BM>
inline int64_t max_row_tiles(int64_t R, int E) {
  return (R + BM - 1) / BM + (E < R ? E : R);
}

}  // namespace
