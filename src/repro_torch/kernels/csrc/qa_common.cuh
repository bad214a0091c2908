// Shared building blocks of the activation-quantized chain kernels
// (sm_90a): int8 x int8 products with exact int32 sums.
//
// The chains keep the cluster design of lrk_common.cuh: one row block of
// BM activation rows per thread block cluster of CLUSTER CTAs, each CTA
// computing 1/CLUSTER of an intermediate's columns, the cluster gathering
// the slices through distributed shared memory.  What changes:
//
//  * x is quantized per row on the fly, as the reference's quantize_rows
//    does: a first pass over the row block takes each row's absmax over
//    all of C (a row of C = 8192 int8 values at BM = 32 would not fit in
//    shared memory), then every staged value is rint(x / safe) clipped
//    to +-127, safe = (absmax / 127 or 1 for an all-zero row);
//  * products run on int8 operands with __dp4a into int32 accumulators,
//    four depths per instruction: exact, as the TPU's int32 MXU sums are;
//  * each dot's sum is folded in the reference's order,
//    (float(acc) * row_scale) * column_scale, with __fmul_rn so nothing is
//    contracted;
//  * an intermediate is gathered in f32, so every CTA of the cluster sees
//    the whole row before it requantizes: all of them derive the same
//    int8 row and the same row scale (absmax over the row, or over the
//    branch's columns of it), which is what the reference's per-row
//    requantization needs.
//
// Division is IEEE (__fdiv_rn, x / safe, never a reciprocal) and rounding
// is round-half-to-even (rintf), so the f32 result equals the plain
// version's bit for bit.
#pragma once

#include "lrk_common.cuh"

namespace qa {

using lrk::CLUSTER;
using lrk::NT;
using lrk::ROW_GROUPS;
using lrk::THREADS;

constexpr int KQ = 64;          // int8 reduction depth staged per step
constexpr int APAD = KQ + 4;    // bytes per staged row: 17 words, so the
                                // 32 columns of a warp hit 32 banks
constexpr float QMAX = 127.f;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float safe_div(float scale) {
  return scale > 0.f ? scale : 1.f;
}

// rint(v / safe) clipped to +-127: the reference's jnp.round (half to
// even) and clip, then the cast to int8.
__device__ __forceinline__ int8_t quant(float v, float safe) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, safe)), -QMAX), QMAX);
  return (int8_t)(int)q;
}

// scale[r] = max_k |x(r, k)| / 127 over the whole row (0 for r >= a_rows),
// one warp per row.
template <typename T, int BM>
__device__ void row_scales(float* scale, const T* x, int ld, int a_rows,
                           int K) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += THREADS / 32) {
    float m = 0.f;
    if (r < a_rows)
      for (int k = lane; k < K; k += 32)
        m = fmaxf(m, fabsf(lrk::to_f32(x[(size_t)r * ld + k])));
    m = warp_max(m);
    if (lane == 0) scale[r] = __fdiv_rn(m, QMAX);
  }
}

// A-operand loaders: at(r, k) is the int8 value, row_scale(r) the f32 row
// scale folded after the dot.
template <typename T> struct XRows {   // activations, quantized on the fly
  const T* x;
  int ld;
  const float* scale;
  __device__ __forceinline__ int8_t at(int r, int k) const {
    return quant(lrk::to_f32(x[(size_t)r * ld + k]), safe_div(scale[r]));
  }
  __device__ __forceinline__ float row_scale(int r) const { return scale[r]; }
};

struct HRows {                         // an int8 intermediate in shared memory
  const int8_t* q;
  int ld;
  const float* scale;                  // row r's scale at scale[r * stride]
  int stride;
  __device__ __forceinline__ int8_t at(int r, int k) const {
    return q[(size_t)r * ld + k];
  }
  __device__ __forceinline__ float row_scale(int r) const {
    return scale[r * stride];
  }
};

// acc[i] += sum_{k<K} A(rg + 4i, k) * B(k, col) in int32, with col =
// tid % NT and rg = tid / NT.  A(r, k) = a.at(r, k), zero for r >= a_rows
// or k >= K; B(k, j) = Bq[k * ldb + j], zero for j >= ncols.  Both are
// staged as int8, KQ depths at a time; B transposed (column-major, rows
// of APAD bytes) so a thread reads four depths of its column as one word.
template <int BM, typename AL>
__device__ __forceinline__ void itile(int (&acc)[BM / ROW_GROUPS], AL a,
                                      int a_rows, const int8_t* Bq, int ldb,
                                      int ncols, int K, int8_t* As,
                                      int8_t* Bs) {
  const int tid = threadIdx.x, col = tid % NT, rg = tid / NT;
  for (int k0 = 0; k0 < K; k0 += KQ) {
    for (int e = tid; e < BM * KQ; e += THREADS) {
      const int r = e / KQ, kk = e % KQ;
      As[r * APAD + kk] =
          (r < a_rows && k0 + kk < K) ? a.at(r, k0 + kk) : (int8_t)0;
    }
    for (int e = tid; e < KQ * NT; e += THREADS) {
      const int kk = e / NT, j = e % NT;
      Bs[j * APAD + kk] = (k0 + kk < K && j < ncols)
                              ? Bq[(size_t)(k0 + kk) * ldb + j] : (int8_t)0;
    }
    __syncthreads();
    const int* brow = reinterpret_cast<const int*>(Bs + col * APAD);
#pragma unroll 4
    for (int w = 0; w < KQ / 4; ++w) {
      const int b4 = brow[w];
#pragma unroll
      for (int i = 0; i < BM / ROW_GROUPS; ++i) {
        const int a4 = reinterpret_cast<const int*>(
            As + (rg + ROW_GROUPS * i) * APAD)[w];
        acc[i] = __dp4a(a4, b4, acc[i]);
      }
    }
    __syncthreads();
  }
}

// This CTA's slice [j0, j1) of an f32 intermediate H (BM rows, row stride
// ldh) whose columns are segments of width RS:
//   H[r, n*RS + c] = (float(A_n(r,:) . Bq_n[:, c]) * A_n.row_scale(r))
//                    * bscale[n*RS + c],
// A_n = seg(n), Bq_n = Bq + n*b_seg (K x RS, row stride RS).
template <int BM, typename SEG>
__device__ void islice(float* H, int ldh, int j0, int j1, int RS, SEG seg,
                       int a_rows, const int8_t* Bq, size_t b_seg,
                       const float* bscale, int K, int8_t* As, int8_t* Bs) {
  const int col = threadIdx.x % NT, rg = threadIdx.x / NT;
  for (int j = j0; j < j1;) {
    const int n = j / RS, c = j % RS;
    const int width = min(NT, min(j1 - j, RS - c));
    const auto a = seg(n);
    int acc[BM / ROW_GROUPS] = {};
    itile<BM>(acc, a, a_rows, Bq + n * b_seg + c, RS, width, K, As, Bs);
    if (col < width) {
      const float bs = bscale[(size_t)n * RS + c + col];
#pragma unroll
      for (int i = 0; i < BM / ROW_GROUPS; ++i) {
        const int r = rg + ROW_GROUPS * i;
        H[(size_t)r * ldh + j + col] = __fmul_rn(
            __fmul_rn(__int2float_rn(acc[i]), a.row_scale(r)), bs);
      }
    }
    j += width;
  }
}

// Requantize H (BM rows, L = nseg*RS columns, row stride L) per row and
// segment: Hs[r*nseg + n] = absmax(H[r, n*RS : (n+1)*RS]) / 127 and
// Hq = quant(H, safe).  One warp per (row, segment).
template <int BM>
__device__ void requant(const float* H, int L, int RS, int nseg, int8_t* Hq,
                        float* Hs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int p = warp; p < BM * nseg; p += THREADS / 32) {
    const int r = p / nseg, n = p % nseg;
    const float* h = H + (size_t)r * L + n * RS;
    float m = 0.f;
    for (int c = lane; c < RS; c += 32) m = fmaxf(m, fabsf(h[c]));
    const float scale = __fdiv_rn(warp_max(m), QMAX);
    const float safe = safe_div(scale);
    int8_t* q = Hq + (size_t)r * L + n * RS;
    for (int c = lane; c < RS; c += 32) q[c] = quant(h[c], safe);
    if (lane == 0) Hs[r * nseg + n] = scale;
  }
}

// y[row0 + r, s0 + j] = round_T( sum_n (float(A_n(r,:) . Wq_n[:, s0 + j])
//                       * A_n.row_scale(r)) * wscale[n*S + s0 + j] ) for
// the output tiles this CTA owns (tile t to CTA t mod gridDim.x of the
// row block); A_n = seg(n) over K depths, Wq_n = Wq + n*K*S (K x S).  The
// branch sum is one f32 accumulator, added in branch order (__fadd_rn).
template <typename T, int BM, typename SEG>
__device__ void ioutput(T* y, int row0, int a_rows, int S, SEG seg,
                        int nseg, int K, const int8_t* Wq,
                        const float* wscale, int8_t* As, int8_t* Bs) {
  const int col = threadIdx.x % NT, rg = threadIdx.x / NT;
  const int n_tiles = (S + NT - 1) / NT;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int s0 = t * NT;
    const int width = min(NT, S - s0);
    float yacc[BM / ROW_GROUPS] = {};
    for (int n = 0; n < nseg; ++n) {
      const auto a = seg(n);
      int acc[BM / ROW_GROUPS] = {};
      itile<BM>(acc, a, BM, Wq + (size_t)n * K * S + s0, S, width, K, As,
                Bs);
      if (col < width) {
        const float ws = wscale[(size_t)n * S + s0 + col];
#pragma unroll
        for (int i = 0; i < BM / ROW_GROUPS; ++i)
          yacc[i] = __fadd_rn(
              yacc[i], __fmul_rn(__fmul_rn(__int2float_rn(acc[i]),
                                           a.row_scale(rg + ROW_GROUPS * i)),
                                 ws));
      }
    }
    if (col < width) {
#pragma unroll
      for (int i = 0; i < BM / ROW_GROUPS; ++i) {
        const int r = rg + ROW_GROUPS * i;
        if (r < a_rows)
          y[(size_t)(row0 + r) * S + s0 + col] = lrk::from_f32<T>(yacc[i]);
      }
    }
  }
}

// Byte offsets of a kernel's shared memory, each region 16-byte aligned.
struct Layout {
  size_t off = 0;
  __host__ __device__ size_t take(size_t bytes) {
    const size_t at = off;
    off = (off + bytes + 15) & ~(size_t)15;
    return at;
  }
};

}  // namespace qa
