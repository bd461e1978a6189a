// flash_attention: causal (or full) GQA attention forward in fp32, online
// softmax
//
//   o[b, s, h, :] = sum_t softmax_t(scale * q[b, s, h, :] . k[b, t, h / G, :])
//                   * v[b, t, h / G, :],   t <= s when causal
//
//   q, o (B, H, S, hd) and k, v (B, K, S, hd) as logical shapes, H = K * G,
//   with any strides of the (b, h, s) axes and a contiguous hd axis: the
//   model passes its (B, S, H, hd) layout without a transpose.
//
// This is the fp32 route; bf16 goes to flash_attention_mma.cu, on the
// tensor cores.  Replaces src/repro/kernels/flash_attention.py:
// flash_attention_pallas.  As there, every product is taken in f32, a
// masked score is -1e30, and the row sum is clamped at 1e-30 before the
// division.  Unlike the TPU kernel, S need not be a multiple of the tile:
// a ragged last tile is bounds-checked (keys past S are masked, queries
// past S are not stored).
//
// What bounds it on an H100: operations.  At the serving shape (B, H, K,
// S, hd) = (4, 32, 8, 1024, 128) causal it does 34.4 GFLOP against 168 MB
// of fp32 traffic; fp32 has no tensor-core route that keeps its digits
// (TF32 keeps about three), so the bound is the CUDA cores' 67 TFLOP/s,
// 0.51 ms, and this kernel does f32 FMAs there.
//
// Design.  One block of 128 threads per (64-row query tile, head, batch),
// the longest causal rows scheduled first.  The query tile is staged once
// in shared memory, transposed (qt[d][r]); then for each 64-row key tile
// (none above the diagonal when causal) K is staged transposed (kt[d][c])
// and V as it is (vs[c][d]).  A thread owns 4 query rows x 8 key columns
// of the score tile (row group ty = tid / 8, column group tx = tid % 8;
// its columns are tx * 4 + {0..3} and 32 + tx * 4 + {0..3}, so the 8
// threads of a quarter-warp read 32 neighbouring floats) and 4 rows x
// hd / 8 columns of the output (d = 32 * jj + tx * 4 + {0..3}).  Per d the
// score loop reads one float4 of q and two of k for 32 FMAs; the row max
// and row sum are butterflies over the 8 threads of a row group.  The
// probabilities go back through shared memory transposed (pt[c][r], in
// the space kt held) for the P V product: per key one float4 of p and
// hd / 32 float4 of v for hd / 2 FMAs.  The running (m, l, acc) stay in
// registers in f32.  hd is padded to a multiple of 32 (a template
// parameter, at most 128) with zeros in q, k and v, which add nothing.
// Shared memory is 100 KB at hd = 128, above the 48 KB a block gets
// without opting in: the launcher raises the limit once per instance, and
// two blocks fit on an SM.  The sums run in a fixed order with no atomics:
// a repeat is bitwise equal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // key rows per tile
constexpr int kThreads = 128;    // 16 row groups x 8 column groups
constexpr int kRows = 4;         // query rows per thread
constexpr int kCols = 8;         // key columns per thread
constexpr int kPad = 4;          // keeps float4 alignment, spreads banks
constexpr int kQStride = kBQ + kPad;
constexpr int kKStride = kBK + kPad;
constexpr int kMaxHd = 128;
constexpr float kNegInf = -1e30f;

struct Strides {
  int64_t b, h, s;
};

// floats of shared memory: qt, then kt (later pt in the same space), then vs
template <int HD>
__host__ __device__ constexpr int kt_floats() {
  return HD * kKStride > kBK * kQStride ? HD * kKStride : kBK * kQStride;
}
template <int HD>
__host__ __device__ constexpr int smem_floats() {
  return HD * kQStride + kt_floats<HD>() + kBK * HD;
}

__device__ __forceinline__ float group8_max(float v) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float group8_sum(float v) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int G, int S, int hd, Strides qs, Strides ks,
                       Strides vst, Strides os, float scale, int causal) {
  constexpr int kJ = HD / 32;    // float4 groups of output columns a thread owns
  constexpr int kKtFloats = kt_floats<HD>();
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                            // [HD][kQStride]
  float* kt = qt + HD * kQStride;              // [HD][kKStride]
  float* pt = kt;                              // [kBK][kQStride], after S
  float* vs = kt + kKtFloats;                  // [kBK][HD]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / G;
  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vst.b + kvh * vst.h;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e - r * HD;
    const int s = q0 + r;
    qt[d * kQStride + r] = (s < S && d < hd) ? qb[s * qs.s + d] : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kJ][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kJ; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  }

  const int kend = causal ? min(S, q0 + kBQ) : S;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();             // the last tile's pt and vs are read
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int c = e / HD, d = e - c * HD;
      const int s = k0 + c;
      const bool in = s < S && d < hd;
      kt[d * kKStride + c] = in ? kb[s * ks.s + d] : 0.f;
      vs[c * HD + d] = in ? vb[s * vst.s + d] : 0.f;
    }
    __syncthreads();

    float sc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 qa =
          *reinterpret_cast<const float4*>(qt + d * kQStride + ty * kRows);
      const float4 ka =
          *reinterpret_cast<const float4*>(kt + d * kKStride + tx * 4);
      const float4 kc =
          *reinterpret_cast<const float4*>(kt + d * kKStride + 32 + tx * 4);
      const float qv[kRows] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[kCols] = {ka.x, ka.y, ka.z, ka.w,
                               kc.x, kc.y, kc.z, kc.w};
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

    // mask, then the online softmax of each row over this tile
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + (j < 4 ? tx * 4 + j : 32 + tx * 4 + j - 4);
        const bool keep = kpos < S && (!causal || kpos <= qpos);
        sc[i][j] = keep ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], group8_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        sum += sc[i][j];
      }
      l[i] = l[i] * corr + group8_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        acc[i][j][0] *= corr;
        acc[i][j][1] *= corr;
        acc[i][j][2] *= corr;
        acc[i][j][3] *= corr;
      }
    }

    __syncthreads();             // every thread is done with kt
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = j < 4 ? tx * 4 + j : 32 + tx * 4 + j - 4;
      *reinterpret_cast<float4*>(pt + c * kQStride + ty * kRows) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    }
    __syncthreads();

    const int cend = min(kBK, kend - k0);
    for (int c = 0; c < cend; ++c) {
      const float4 pa =
          *reinterpret_cast<const float4*>(pt + c * kQStride + ty * kRows);
      const float pv[kRows] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const float4 va =
            *reinterpret_cast<const float4*>(vs + c * HD + j * 32 + tx * 4);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          acc[i][j][0] = fmaf(pv[i], va.x, acc[i][j][0]);
          acc[i][j][1] = fmaf(pv[i], va.y, acc[i][j][1]);
          acc[i][j][2] = fmaf(pv[i], va.z, acc[i][j][2]);
          acc[i][j][3] = fmaf(pv[i], va.w, acc[i][j][3]);
        }
      }
    }
  }

  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int s = q0 + ty * kRows + i;
    if (s >= S) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = j * 32 + tx * 4 + e;
        if (d < hd) ob[s * os.s + d] = acc[i][j][e] * inv_l;
      }
  }
}

template <int HD>
int launch_hd(const float* q, const float* k, const float* v, float* o,
              int B, int H, int G, int S, int hd, Strides qs, Strides ks,
              Strides vs, Strides os, float scale, int causal,
              cudaStream_t stream) {
  constexpr size_t bytes = smem_floats<HD>() * sizeof(float);
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<HD><<<grid, kThreads, bytes, stream>>>(
      q, k, v, o, G, S, hd, qs, ks, vs, os, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: device pointers to float; the logical shapes (B, H, S, hd)
// for q and o, (B, K, S, hd) for k and v; strides: 12 element strides, the
// (b, h, s) strides of q, k, v and o in that order (hd is contiguous).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_flash_attention_f32(const void* q, const void* k,
                                         const void* v, void* o, int B,
                                         int H, int K, int S, int hd,
                                         const int64_t* strides, float scale,
                                         int causal, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (H <= 0 || K <= 0 || H % K != 0 || hd <= 0 || hd > kMaxHd ||
      H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  const float* qq = static_cast<const float*>(q);
  const float* kk = static_cast<const float*>(k);
  const float* vv = static_cast<const float*>(v);
  float* oo = static_cast<float*>(o);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / K;
  if (hd <= 32)
    return launch_hd<32>(qq, kk, vv, oo, B, H, G, S, hd, qs, ks, vs, os,
                         scale, causal, s);
  if (hd <= 64)
    return launch_hd<64>(qq, kk, vv, oo, B, H, G, S, hd, qs, ks, vs, os,
                         scale, causal, s);
  if (hd <= 96)
    return launch_hd<96>(qq, kk, vv, oo, B, H, G, S, hd, qs, ks, vs, os,
                         scale, causal, s);
  return launch_hd<128>(qq, kk, vv, oo, B, H, G, S, hd, qs, ks, vs, os,
                        scale, causal, s);
}
