// flash_attention: causal (or full) GQA attention forward in fp32, on the
// tensor cores in 3xTF32
//
//   o[b, s, h, :] = sum_t softmax_t(scale * q[b, s, h, :] . k[b, t, h / G, :])
//                   * v[b, t, h / G, :],   t <= s when causal
//
//   q, o (B, H, S, hd) and k, v (B, K, S, hd) as logical shapes, H = K * G,
//   with any strides of the (b, h, s) axes and a contiguous hd axis: the
//   model passes its (B, S, H, hd) layout without a transpose, and K / V
//   un-repeated (head h reads KV head h / G).
//
// This is the fp32 route; bf16 goes to flash_attention_mma.cu.  Replaces
// src/repro/kernels/flash_attention.py: flash_attention_pallas.  As there,
// every product keeps f32's digits (below), a masked score is -1e30, the
// running (m, l, acc) are f32 and the row sum is clamped at 1e-30 before
// the division.  Unlike the TPU kernel, S need not be a multiple of the
// tile: keys past S are masked (zeros in shared memory) and queries past S
// are not stored.
//
// The products: 3xTF32.  One TF32 pass keeps 10 bits of each operand's
// mantissa, about 1e-3 off in a product.  Here each operand is split as
// x = hi + lo, hi = tf32(x), lo = tf32(x - hi) (cvt.rna: round to nearest,
// ties away from zero), and a product is lo_a hi_b + hi_a lo_b + hi_a hi_b,
// each term an mma.sync.m16n8k8 tf32 -> f32 into the same accumulator, the
// two small terms first (as CUTLASS's 3xTF32 issues them); lo_a lo_b
// (below 2^-22 of the product) is dropped.  That keeps about 21 bits a
// product, well inside the 2e-5 per output row that fp32 is held to.
//
// What bounds it on an H100: operations.  At the serving shape (B, H, K,
// S, hd) = (4, 32, 8, 1024, 128) causal it does 34.4 GFLOP (4 per
// query-key pair and head dimension), three times on the tensor cores:
// 103.1 GFLOP at the dense TF32 rate of 495 TFLOP/s is 0.2084 ms (on the
// CUDA cores the same 34.4 GFLOP at 67 TFLOP/s take 0.5133 ms, the bound
// of the design before this one); its 168 MB of q, k, v and o take 0.050
// ms at 3.35 TB/s, below that.
//
// Design.  One block of 4 warps per (64-row query tile, head, batch), the
// longest causal rows scheduled first; each warp owns 16 query rows.  The
// query tile is staged once; K and V come in per 32-key tile into a ring
// of two stages (cp.async), so the copies of the next tile overlap the
// products of this one.  A warp skips a key tile that lies wholly above
// its 16 rows.  S = Q K^T runs over pairs of k-steps: the sum over the
// head dimension does not depend on its order, so within 16 columns slot
// t of the first k-step is column 4t and slot t + 4 column 4t + 1, of the
// second 4t + 2 and 4t + 3, for Q's A fragments and K's B fragments alike:
// one 16-byte load of a Q row (rows g and g + 8) or a K row feeds both
// k-steps.  The online softmax runs on the f32 accumulator fragments in
// the base-2 domain (scores times scale * log2 e, then exp2); a row's max
// is a 2-step __shfl_xor over the 4 lanes that share it, its sum is kept
// per lane and summed over them once at the end; the causal mask is
// applied only on the diagonal tiles, the key bound only on the ragged
// last one.  O += P V with no shuffles: the accumulator gives lane (g, t)
// key columns 2t and 2t + 1 of an 8-key n-tile, and the A fragment wants
// slots t and t + 4, so within each 8-key group slot t is key 2t and slot
// t + 4 key 2t + 1 (the sum over keys does not depend on their order
// either): the S accumulators are P's A fragments in place, and V's B
// fragments are read from the same keys.  The output columns are
// relabelled too, so that a lane reads 4 neighbouring V columns in one
// 16-byte load: slot g of n-tile 4p + i is column 32p + 4g + i, which puts
// columns 32p + 8t .. + 7 of rows g and g + 8 in a lane's accumulators
// (two 16-byte stores a row at the end).  O (16 x HD a warp) stays in f32
// registers; each tile's P V runs into accumulators of its own and joins O
// in one rounded FMA, O corr + P V (the tensor cores truncate their sums,
// and 384 of them into O itself at S = 1024 would cost most of fp32's
// bar); at the end O is scaled by 1 / l and stored through o's strides.
// hd is padded with zeros in shared memory to HD, a template parameter
// (32, 64, 96 or 128).  Loads are 16-byte cp.async
// when every row start is 16-byte aligned (hd % 4 == 0, aligned pointers,
// strides multiples of 4); otherwise element loads into the same layout
// (the template flag VEC, chosen by the launcher).  Row strides make every
// fragment load conflict-free: HD + 16 floats for Q and K (a quarter
// warp's 16-byte loads span rows g and g + 1 at columns 4t), HD + 4 for V
// (rows 2t and 2t + 1, columns 4g).  The sums run in a fixed order with no
// atomics: a repeat is bitwise equal.
//
// Where the split happens, and why.  Each warp splits the fragments it
// loads, five integer and float instructions an element (tf32_rna in
// mma_fp32_fp64.cuh), repeated by the four warps for K and V.  Splitting
// once per tile into hi and lo planes at staging would spare that, but
// doubles what is staged: a 32-key stage of K and V is 35 KB at HD = 128,
// 71 KB as hi and lo planes,
// two stages 141 KB, with Q's 37 KB beside them; a block may hold 113 KB
// if two are to share an SM, and one block of 4 warps per SM leaves each
// scheduler one warp to hide the mma.sync latency with.  So the tiles are
// 32 keys, the ring holds raw fp32 (Q 37 KB + two stages of K and V 69 KB
// = 105 KB at HD = 128; the launcher raises the 48 KB default once per
// instance) and two blocks share an SM, two warps a scheduler.  Splitting
// once per tile, with 8 warps over 128 query rows to make room for the
// planes (one block an SM), ran no faster on an H100 at the serving
// shape: a tile's other instructions do not hide behind its mma.sync, and
// the two extra passes' mma.sync and their lo splits are most of the time
// that is left.
//
// What it leaves for wgmma: mma.sync issues from each warp and reads its
// operands from registers, and three products triple that; wgmma (64-row
// asynchronous products, B from shared memory) takes tf32 only K-major,
// so V must be staged transposed (keys contiguous), and the hi and lo
// parts of K and V must both lie in shared memory, split once at staging;
// every thread still spends instructions on the copies (TMA: one thread,
// a barrier).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_fp32_fp64.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per block, 16 per warp
constexpr int kBK = 32;          // key rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHd = 128;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  int64_t b, h, s;
};

// row strides in floats of the staged tiles (see the header)
template <int HD>
__host__ __device__ constexpr int qk_stride() {
  return HD + 16;
}
template <int HD>
__host__ __device__ constexpr int v_stride() {
  return HD + 4;
}
// floats of shared memory: the query tile, two stages of K, two of V
template <int HD>
__host__ __device__ constexpr int smem_floats() {
  return kBQ * qk_stride<HD>() + 2 * kBK * (qk_stride<HD>() + v_stride<HD>());
}

// rows row0 .. row0 + ROWS - 1 of a (S, hd) slab with row stride ld into
// a [ROWS][STRIDE] tile; rows past S and columns past hd are zeros.  VEC:
// 16-byte cp.async (the caller commits the group); else element loads.
template <int ROWS, int STRIDE, int HD, bool VEC>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t ld, int row0, int S,
                                          int hd, int tid) {
  if (VEC) {
    constexpr int kChunks = HD / 4;          // 16-byte chunks per row
#pragma unroll
    for (int c = tid; c < ROWS * kChunks; c += kThreads) {
      const int r = c / kChunks;
      const int d = (c - r * kChunks) * 4;
      const int s = row0 + r;
      const bool in = s < S && d < hd;
      const float* g = in ? src + (int64_t)s * ld + d : src;
      cp_async16(smem_addr(dst + r * STRIDE + d), g, in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < ROWS * HD; e += kThreads) {
      const int r = e / HD;
      const int d = e - r * HD;
      const int s = row0 + r;
      dst[r * STRIDE + d] = (s < S && d < hd) ? src[(int64_t)s * ld + d] : 0.f;
    }
  }
}

template <int HD, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int G, int S, int hd, Strides qs, Strides ks,
                       Strides vst, Strides os, float scale_log2,
                       int causal) {
  constexpr int kQK = qk_stride<HD>();
  constexpr int kV = v_stride<HD>();
  constexpr int kKTile = kBK * kQK;
  constexpr int kVTile = kBK * kV;
  constexpr int kP = HD / 16;    // pairs of k-steps of Q K^T
  constexpr int kN = kBK / 8;    // n-tiles of a score tile; k-steps of P V
  constexpr int kO = HD / 32;    // groups of four output n-tiles
  extern __shared__ __align__(16) float smem[];
  float* qsm = smem;                       // [kBQ][kQK]
  float* ksm = qsm + kBQ * kQK;            // 2 stages of [kBK][kQK]
  float* vsm = ksm + 2 * kKTile;           // 2 stages of [kBK][kV]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / G;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vst.b + kvh * vst.h;

  const int kend = causal ? min(S, q0 + kBQ) : S;
  const int ntiles = (kend + kBK - 1) / kBK;
  const int wq0 = q0 + warp * 16;          // the warp's first query row

  load_tile<kBQ, kQK, HD, VEC>(qsm, qb, qs.s, q0, S, hd, tid);
  cp_async_commit();
  load_tile<kBK, kQK, HD, VEC>(ksm, kb, ks.s, 0, S, hd, tid);
  load_tile<kBK, kV, HD, VEC>(vsm, vb, vst.s, 0, S, hd, tid);
  cp_async_commit();

  // n-tile 4p + i of O: slot n is column 32p + 4n + i, so element e is
  // row g + 8 (e >> 1), column 32p + 8t + 4 (e & 1) + i
  float acc[4 * kO][4];
#pragma unroll
  for (int j = 0; j < 4 * kO; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // this lane's rows: g and g + 8 of the warp's 16
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  const int qrow = wq0 + g;
  const float* qw = qsm + (warp * 16 + g) * kQK + 4 * t;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBK;
    if (it + 1 < ntiles) {
      const int nxt = (it + 1) & 1;
      load_tile<kBK, kQK, HD, VEC>(ksm + nxt * kKTile, kb, ks.s, k0 + kBK, S,
                                   hd, tid);
      load_tile<kBK, kV, HD, VEC>(vsm + nxt * kVTile, vb, vst.s, k0 + kBK, S,
                                  hd, tid);
    }
    cp_async_commit();           // an empty group on the last tile
    cp_async_wait<1>();         // the query tile and tile it have landed
    __syncthreads();
    if (!causal || k0 <= wq0 + 15) {
      const float* kt = ksm + (it & 1) * kKTile;
      const float* vt = vsm + (it & 1) * kVTile;

      // S = Q K^T, 16 x 32 a warp: n-tile j is keys 8 j .. 8 j + 7, its
      // B fragment key 8 j + g of K's rows
      float sc[kN][4];
#pragma unroll
      for (int j = 0; j < kN; ++j)
        sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const float4 qa = *reinterpret_cast<const float4*>(qw + 16 * p);
        const float4 qc =
            *reinterpret_cast<const float4*>(qw + 8 * kQK + 16 * p);
        // A fragments of k-steps 2p (x, y) and 2p + 1 (z, w): rows g,
        // g + 8 at slot t, then at slot t + 4
        uint32_t ah[2][4], al[2][4];
        split_tf32(qa.x, ah[0][0], al[0][0]);
        split_tf32(qc.x, ah[0][1], al[0][1]);
        split_tf32(qa.y, ah[0][2], al[0][2]);
        split_tf32(qc.y, ah[0][3], al[0][3]);
        split_tf32(qa.z, ah[1][0], al[1][0]);
        split_tf32(qc.z, ah[1][1], al[1][1]);
        split_tf32(qa.w, ah[1][2], al[1][2]);
        split_tf32(qc.w, ah[1][3], al[1][3]);
        uint32_t bh[kN][4], bl[kN][4];
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(
              kt + (8 * j + g) * kQK + 16 * p + 4 * t);
          split_tf32(kv.x, bh[j][0], bl[j][0]);
          split_tf32(kv.y, bh[j][1], bl[j][1]);
          split_tf32(kv.z, bh[j][2], bl[j][2]);
          split_tf32(kv.w, bh[j][3], bl[j][3]);
        }
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int j = 0; j < kN; ++j)
            mma_3xtf32(sc[j], ah[s], al[s], bh[j][2 * s], bh[j][2 * s + 1],
                       bl[j][2 * s], bl[j][2 * s + 1]);
      }

      // scale into the base-2 domain, mask, then the online softmax;
      // element e of an n-tile is row g + 8 (e >> 1), key 2t + (e & 1)
      const bool edge =
          k0 + kBK > S || (causal && k0 + kBK - 1 > wq0);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[j][e] * scale_log2;
          if (edge) {
            const int kpos = k0 + 8 * j + 2 * t + (e & 1);
            const int qpos = qrow + 8 * (e >> 1);
            if (kpos >= S || (causal && kpos > qpos)) x = kNegInf;
          }
          sc[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = exp2f(sc[j][e] - m[e >> 1]);
          sum[e >> 1] += sc[j][e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];

      // O = O corr + P V: k-step j is keys 8 j .. + 7, slot t key 2t, slot
      // t + 4 key 2t + 1, so P's A fragment is n-tile j's accumulator in
      // place.  The tile's product runs into accumulators of its own, 12
      // mma.sync deep, and joins O in one rounded f32 FMA (see the header).
      uint32_t ph[kN][4], pl[kN][4];
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        split_tf32(sc[j][0], ph[j][0], pl[j][0]);
        split_tf32(sc[j][2], ph[j][1], pl[j][1]);
        split_tf32(sc[j][1], ph[j][2], pl[j][2]);
        split_tf32(sc[j][3], ph[j][3], pl[j][3]);
      }
      const float* v0 = vt + 2 * t * kV + 4 * g;
#pragma unroll
      for (int p = 0; p < kO; ++p) {
        float pv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pv[i][0] = pv[i][1] = pv[i][2] = pv[i][3] = 0.f;
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          const float4 va =
              *reinterpret_cast<const float4*>(v0 + 8 * j * kV + 32 * p);
          const float4 vc = *reinterpret_cast<const float4*>(
              v0 + (8 * j + 1) * kV + 32 * p);
          const float a[4] = {va.x, va.y, va.z, va.w};
          const float c[4] = {vc.x, vc.y, vc.z, vc.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            uint32_t bh0, bh1, bl0, bl1;
            split_tf32(a[i], bh0, bl0);
            split_tf32(c[i], bh1, bl1);
            mma_3xtf32(pv[i], ph[j], pl[j], bh0, bh1, bl0, bl1);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* o4 = acc[4 * p + i];
          o4[0] = fmaf(o4[0], corr[0], pv[i][0]);
          o4[1] = fmaf(o4[1], corr[0], pv[i][1]);
          o4[2] = fmaf(o4[2], corr[1], pv[i][2]);
          o4[3] = fmaf(o4[3], corr[1], pv[i][3]);
        }
      }
    }
    __syncthreads();             // every warp is done with this stage
  }

  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float inv_l = 1.f / fmaxf(lr, 1e-30f);
    const int s = qrow + 8 * r;
    if (s >= S) continue;
    float* row = ob + (int64_t)s * os.s;
#pragma unroll
    for (int p = 0; p < kO; ++p)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = 32 * p + 8 * t + 4 * c;
        const float x[4] = {acc[4 * p][2 * r + c] * inv_l,
                            acc[4 * p + 1][2 * r + c] * inv_l,
                            acc[4 * p + 2][2 * r + c] * inv_l,
                            acc[4 * p + 3][2 * r + c] * inv_l};
        if (VEC) {
          if (d < hd)
            *reinterpret_cast<float4*>(row + d) =
                make_float4(x[0], x[1], x[2], x[3]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (d + i < hd) row[d + i] = x[i];
        }
      }
  }
}

template <int HD, bool VEC>
int launch_hd(const float* q, const float* k, const float* v, float* o,
              int B, int H, int G, int S, int hd, Strides qs, Strides ks,
              Strides vs, Strides os, float scale_log2, int causal,
              cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * (int)sizeof(float);
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<HD, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<HD, VEC><<<grid, kThreads, bytes, stream>>>(
      q, k, v, o, G, S, hd, qs, ks, vs, os, scale_log2, causal);
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_vec(const float* q, const float* k, const float* v, float* o,
               int B, int H, int G, int S, int hd, Strides qs, Strides ks,
               Strides vs, Strides os, float scale_log2, int causal,
               cudaStream_t st) {
  if (hd <= 32)
    return launch_hd<32, VEC>(q, k, v, o, B, H, G, S, hd, qs, ks, vs, os,
                              scale_log2, causal, st);
  if (hd <= 64)
    return launch_hd<64, VEC>(q, k, v, o, B, H, G, S, hd, qs, ks, vs, os,
                              scale_log2, causal, st);
  if (hd <= 96)
    return launch_hd<96, VEC>(q, k, v, o, B, H, G, S, hd, qs, ks, vs, os,
                              scale_log2, causal, st);
  return launch_hd<128, VEC>(q, k, v, o, B, H, G, S, hd, qs, ks, vs, os,
                             scale_log2, causal, st);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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
  bool vec = hd % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
             aligned16(o);
  for (int i = 0; i < 12; ++i) vec = vec && strides[i] % 4 == 0;
  const float* qq = static_cast<const float*>(q);
  const float* kk = static_cast<const float*>(k);
  const float* vv = static_cast<const float*>(v);
  float* oo = static_cast<float*>(o);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / K;
  const float scale_log2 = scale * kLog2e;
  if (vec)
    return launch_vec<true>(qq, kk, vv, oo, B, H, G, S, hd, qs, ks, vs, os,
                            scale_log2, causal, st);
  return launch_vec<false>(qq, kk, vv, oo, B, H, G, S, hd, qs, ks, vs, os,
                           scale_log2, causal, st);
}
