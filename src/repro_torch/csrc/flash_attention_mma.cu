// flash_attention_mma: causal (or full) GQA attention forward in bf16, on
// the tensor cores
//
//   o[b, s, h, :] = sum_t softmax_t(scale * q[b, s, h, :] . k[b, t, h / G, :])
//                   * v[b, t, h / G, :],   t <= s when causal
//
//   q, o (B, H, S, hd) and k, v (B, K, S, hd) as logical shapes, H = K * G,
//   bf16, with any strides of the (b, h, s) axes and a contiguous hd axis:
//   the model passes its (B, S, H, hd) layout without a transpose, and K / V
//   un-repeated (head h reads KV head h / G).  This is the bf16 route;
//   flash_attention.cu is the fp32 route (f32 FMAs on the CUDA cores).
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention_pallas.
// As there, a masked score is -1e30, the running (m, l, acc) are f32 and
// the row sum is clamped at 1e-30 before the division.  Q K^T takes bf16
// operands with f32 accumulation, exact per product as the TPU kernel's
// widened f32 dot is; the one new rounding is P to bf16 before P V.  S
// need not be a multiple of the tile: keys past S are masked (zeros in
// shared memory) and queries past S are not stored.
//
// What bounds it on an H100: operations.  At the serving shape (B, H, K,
// S, hd) = (4, 32, 8, 1024, 128) causal it does 34.4 GFLOP (4 per
// query-key pair and head dimension), 0.0348 ms at the tensor cores' 989
// TFLOP/s in bf16; its 84 MB of q, k, v and o take 0.025 ms at 3.35 TB/s,
// below that.  This design puts both products on the tensor cores through
// warp-level mma.sync (bf16 -> f32, m16n8k16), fed by ldmatrix from
// shared memory that a two-stage cp.async ring fills, so the copies of
// the next key tile overlap the products of this one.  What it leaves for
// wgmma + TMA: mma.sync issues from each warp and holds the tensor cores
// to a fraction of their rate (wgmma's 64-row asynchronous products read
// B straight from shared memory); every thread spends instructions on the
// copies (TMA: one thread, a barrier); and whole 64 x 64 tiles on the
// diagonal, 6% above the causal count at S = 1024.
//
// Design.  One block of 4 warps per (64-row query tile, head, batch), the
// longest causal rows scheduled first; each warp owns 16 query rows.  The
// query tile is staged once and each warp keeps its Q fragments in
// registers (ldmatrix.x4) for the whole key loop.  K and V come in per
// 64-row key tile into a ring of two stages; rows are padded by 8 bf16 (a
// row stride of HD + 8, so the 8 rows an ldmatrix reads fall in distinct
// banks).  S = Q K^T: K is the "col" operand, read with plain ldmatrix.
// The online softmax runs on the f32 accumulator fragments in the base-2
// domain (scores times scale * log2 e, then exp2); a row's max is a
// 2-step __shfl_xor over the 4 lanes that share it, its sum is kept per
// lane and summed over them once at the end; the causal mask is applied
// only on the diagonal tile, the key bound only on the ragged last one.
// O += P V: the m16n8 accumulators of two adjacent key groups are the
// m16k16 A operand, so P goes to bf16 in registers; V is read with
// ldmatrix.trans.  O (16 x HD a warp) stays in f32 registers, rescaled per
// tile, then scaled by 1 / l, rounded to bf16 and stored through o's
// strides.  hd is padded with zeros in shared memory to HD, a template
// parameter (16, 32, 64, 96 or 128).  Loads are 16-byte cp.async when
// every row start is 16-byte aligned (hd % 8 == 0, aligned pointers,
// strides multiples of 8); otherwise element loads into the same layout
// (the template flag VEC, chosen by the launcher).  Shared memory is 85 KB
// at HD = 128, above the 48 KB a block gets without opting in: the
// launcher raises the limit once per instance, and two blocks fit on an
// SM.  The sums run in a fixed order with no atomics: a repeat is bitwise
// equal.

#include "mma_bf16.cuh"

namespace {

constexpr int kBlock = 64;       // query rows per block, key rows per tile
constexpr int kWarps = 4;        // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;          // bf16 of padding per shared-memory row
constexpr int kMaxHd = 128;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  int64_t b, h, s;
};

template <int HD>
__host__ __device__ constexpr int tile_elems() {
  return kBlock * (HD + kPad);
}
// bf16 of shared memory: the query tile, then two stages of K, then two of V
template <int HD>
__host__ __device__ constexpr int smem_bytes() {
  return 5 * tile_elems<HD>() * (int)sizeof(bf16);
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// two f32 values as a bf16 pair, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows row0 .. row0 + 63 of a (S, hd) slab with row stride ld into a
// [kBlock][HD + kPad] tile; rows past S and columns past hd are zeros.
// VEC: 16-byte cp.async (the caller commits the group); else element loads.
template <int HD, bool VEC>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int64_t ld, int row0, int S,
                                          int hd, int tid) {
  constexpr int kStride = HD + kPad;
  if (VEC) {
    constexpr int kChunks = HD / 8;          // 16-byte chunks per row
#pragma unroll
    for (int c = tid; c < kBlock * kChunks; c += kThreads) {
      const int r = c / kChunks;
      const int d = (c - r * kChunks) * 8;
      const int s = row0 + r;
      const bool in = s < S && d < hd;
      const bf16* g = in ? src + (int64_t)s * ld + d : src;
      cp_async16(smem_addr(dst + r * kStride + d), g, in ? 16 : 0);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int e = tid; e < kBlock * HD; e += kThreads) {
      const int r = e / HD;
      const int d = e - r * HD;
      const int s = row0 + r;
      dst[r * kStride + d] =
          (s < S && d < hd) ? src[(int64_t)s * ld + d] : zero;
    }
  }
}

template <int HD, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_mma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o,
                           int G, int S, int hd, Strides qs, Strides ks,
                           Strides vst, Strides os, float scale_log2,
                           int causal) {
  constexpr int kStride = HD + kPad;
  constexpr int kTile = tile_elems<HD>();
  constexpr int kD = HD / 16;    // k-steps of Q K^T; pairs of n-tiles of P V
  constexpr int kN = kBlock / 8; // n-tiles of a score row block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qsm = reinterpret_cast<bf16*>(smem_raw);    // [kBlock][kStride]
  bf16* ksm = qsm + kTile;                           // 2 stages
  bf16* vsm = ksm + 2 * kTile;                       // 2 stages

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / G;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vst.b + kvh * vst.h;

  const int kend = causal ? min(S, q0 + kBlock) : S;
  const int ntiles = (kend + kBlock - 1) / kBlock;

  load_tile<HD, VEC>(qsm, qb, qs.s, q0, S, hd, tid);
  cp_async_commit();
  load_tile<HD, VEC>(ksm, kb, ks.s, 0, S, hd, tid);
  load_tile<HD, VEC>(vsm, vb, vst.s, 0, S, hd, tid);
  cp_async_commit();
  cp_async_wait_one();           // the query tile has landed
  __syncthreads();

  // A fragments of this warp's 16 query rows: matrix i of the x4 load is
  // rows 8 (i & 1) .. + 7, columns 8 (i >> 1) .. + 7 of a 16 x 16 block
  uint32_t qf[kD][4];
#pragma unroll
  for (int kk = 0; kk < kD; ++kk)
    ldmatrix_x4(qf[kk], smem_addr(qsm + (warp * 16 + (lane & 15)) * kStride +
                                  kk * 16 + (lane >> 4) * 8));

  float acc[2 * kD][4];
#pragma unroll
  for (int j = 0; j < 2 * kD; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // this lane's rows: g and g + 8 of the warp's 16 (g = lane / 4)
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  const int qrow = q0 + warp * 16 + (lane >> 2);
  const int kcol = 2 * (lane & 3);   // the lane's first column of an n-tile

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kBlock;
    if (t + 1 < ntiles) {
      const int nxt = (t + 1) & 1;
      load_tile<HD, VEC>(ksm + nxt * kTile, kb, ks.s, k0 + kBlock, S, hd,
                         tid);
      load_tile<HD, VEC>(vsm + nxt * kTile, vb, vst.s, k0 + kBlock, S, hd,
                         tid);
    }
    cp_async_commit();           // an empty group on the last tile
    cp_async_wait_one();         // tile t has landed
    __syncthreads();
    const bf16* kt = ksm + (t & 1) * kTile;
    const bf16* vt = vsm + (t & 1) * kTile;

    // S = Q K^T, 16 x 64 a warp: n-tile j is keys 8 j .. 8 j + 7.  Matrix i
    // of the x4 load is keys 8 (i >> 1) .. + 7 of a 16-key pair of
    // n-tiles, columns 8 (i & 1) .. + 7 of a 16-column k-step.
    float sc[kN][4];
#pragma unroll
    for (int j = 0; j < kN; ++j)
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD; ++kk)
#pragma unroll
      for (int jj = 0; jj < kN / 2; ++jj) {
        uint32_t r[4];
        ldmatrix_x4(r, smem_addr(kt +
                                 (jj * 16 + (lane & 7) + (lane >> 4) * 8) *
                                     kStride +
                                 kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(sc[2 * jj], qf[kk], r[0], r[1]);
        mma_bf16(sc[2 * jj + 1], qf[kk], r[2], r[3]);
      }

    // scale into the base-2 domain, mask, then the online softmax; element
    // e of an n-tile is row g + 8 (e >> 1), column kcol + (e & 1)
    const bool edge = k0 + kBlock > S || (causal && k0 + kBlock - 1 > q0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * scale_log2;
        if (edge) {
          const int kpos = k0 + 8 * j + kcol + (e & 1);
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
#pragma unroll
    for (int j = 0; j < 2 * kD; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // O += P V: the accumulators of n-tiles 2 kk and 2 kk + 1 are the A
    // fragment of keys 16 kk .. + 15.  Matrix i of the transposed x4 load
    // is keys 8 (i & 1) .. + 7, columns 8 (i >> 1) .. + 7 of a 16-column
    // pair of output n-tiles.
#pragma unroll
    for (int kk = 0; kk < kN / 2; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
          pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
          pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int jd = 0; jd < kD; ++jd) {
        uint32_t r[4];
        ldmatrix_x4_trans(
            r, smem_addr(vt +
                         (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                             kStride +
                         jd * 16 + (lane >> 4) * 8));
        mma_bf16(acc[2 * jd], pa, r[0], r[1]);
        mma_bf16(acc[2 * jd + 1], pa, r[2], r[3]);
      }
    }
    __syncthreads();             // every warp is done with this stage
  }

  bf16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i] + __shfl_xor_sync(0xffffffffu, l[i], 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const float inv_l = 1.f / fmaxf(li, 1e-30f);
    const int s = qrow + 8 * i;
    if (s >= S) continue;
    bf16* row = ob + (int64_t)s * os.s;
#pragma unroll
    for (int j = 0; j < 2 * kD; ++j) {
      const int d = 8 * j + kcol;
      const float x0 = acc[j][2 * i] * inv_l;
      const float x1 = acc[j][2 * i + 1] * inv_l;
      if (VEC) {
        if (d < hd)
          *reinterpret_cast<__nv_bfloat162*>(row + d) =
              __floats2bfloat162_rn(x0, x1);
      } else {
        if (d < hd) row[d] = __float2bfloat16(x0);
        if (d + 1 < hd) row[d + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int HD, bool VEC>
int launch_hd(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B,
              int H, int G, int S, int hd, Strides qs, Strides ks, Strides vs,
              Strides os, float scale_log2, int causal, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_mma_kernel<HD, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid((S + kBlock - 1) / kBlock, H, B);
  flash_attention_mma_kernel<HD, VEC><<<grid, kThreads, bytes, stream>>>(
      q, k, v, o, G, S, hd, qs, ks, vs, os, scale_log2, causal);
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_vec(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B,
               int H, int G, int S, int hd, Strides qs, Strides ks,
               Strides vs, Strides os, float scale_log2, int causal,
               cudaStream_t st) {
  if (hd <= 16)
    return launch_hd<16, VEC>(q, k, v, o, B, H, G, S, hd, qs, ks, vs, os,
                              scale_log2, causal, st);
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

// q, k, v, o: device pointers to bf16; the logical shapes (B, H, S, hd) for
// q and o, (B, K, S, hd) for k and v; strides: 12 element strides, the
// (b, h, s) strides of q, k, v and o in that order (hd is contiguous).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* o, int B,
                                          int H, int K, int S, int hd,
                                          const int64_t* strides,
                                          float scale, int causal,
                                          void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (H <= 0 || K <= 0 || H % K != 0 || hd <= 0 || hd > kMaxHd ||
      H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  bool vec = hd % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
             aligned16(o);
  for (int i = 0; i < 12; ++i) vec = vec && strides[i] % 8 == 0;
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  bf16* oo = static_cast<bf16*>(o);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / K;
  const float scale_log2 = scale * kLog2e;
  if (vec)
    return launch_vec<true>(qq, kk, vv, oo, B, H, G, S, hd, qs, ks, vs, os,
                            scale_log2, causal, st);
  return launch_vec<false>(qq, kk, vv, oo, B, H, G, S, hd, qs, ks, vs, os,
                           scale_log2, causal, st);
}
