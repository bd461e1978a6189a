// Warp-level helpers of the f32 and f64 tensor-core kernels
// (flash_attention.cu, grouped_mm.cu, block_jacobi_apply_batched.cu):
// cp.async copies, the TF32 split and 3xTF32 product on mma.sync m16n8k8,
// and the fp64 mma.sync m16n8k16, with their fragment layouts.
//
// Fragment layouts, lane l = 4 g + t of a warp:
//   A (16 x kK, row-major): a[i] = A[g + 8 (i % 2)][t + 4 (i / 2)],
//     i < 4 (TF32, kK = 8) or i < 8 (f64, kK = 16);
//   B (kK x 8, column-major): b[i] = B[t + 4 i][g], i < kK / 4;
//   D (16 x 8): d[0..1] = D[g][2 t + {0, 1}],
//     d[2..3] = D[g + 8][2 t + {0, 1}].

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, past L1; src_bytes 0 fills zeros
// and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// one element of BYTES (4 or 8) from global to shared memory; src_bytes 0
// fills zeros and reads nothing
template <int BYTES>
__device__ __forceinline__ void cp_async_elem(uint32_t dst, const void* src,
                                              int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
               "l"(src), "n"(BYTES), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x (10 mantissa
// bits, to nearest, ties away from zero): half of the dropped unit added to
// the magnitude bits, then the 13 low bits cleared, two integer
// instructions where ptxas expands the cvt into four with its NaN test (a
// NaN x still gives a NaN lo below, so a NaN input still reaches the sums)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo as two TF32 numbers (f32 bit patterns, low 13 bits zero)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a b: a the 16 x 8 row-major A fragment, (b0, b1) the 8 x 8
// column-major B fragment, d the 16 x 8 f32 accumulator.  The tensor cores
// add the 8 products and d exactly and truncate the sum to f32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: the small terms first (as CUTLASS's 3xTF32 issues
// them), lo_a lo_b (below 2^-22 of the product) dropped
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// D += A B on the fp64 tensor cores, one 16 x 8 x 16 product a warp (a
// shape sm_90 added, at the card's full fp64 tensor rate): the layouts of
// the header, a[8], b[4]
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[8],
                                     const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

}  // namespace
