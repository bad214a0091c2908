// Shared building blocks of the low-rank chain kernels (sm_90a).
//
// Every kernel here computes a chain of matrix products for one block of
// BM activation rows and keeps the rank intermediates in shared memory.
// A thread block cluster of CLUSTER CTAs shares one row block: each CTA
// computes a slice of an intermediate's columns, and the cluster then
// gathers the slices through distributed shared memory, so the weights
// of a stage are read once per cluster instead of once per CTA.
//
// Products accumulate in f32 with plain FMAs; an intermediate is rounded
// to the activation type T (round to nearest even) before it feeds the
// next product, as the reference does.  Ragged M, K and N are masked on
// every load and store, so no operand needs padding.
//
// The weight operand of a product is a view: Plain<T> reads T values;
// Dequant<T, Q> reads int8 or e4m3 values and multiplies each by its
// output column's f32 scale, rounding the product to T before it is
// widened back to f32 for the FMA -- the TPU kernels dequantize the
// factor to x.dtype before the dot (lowrank_matmul_q.py:42-48,
// branched_matmul_q.py:47-49), and skipping that rounding would break
// agreement with the plain version at bf16.  Sparse24<T, Q> reads a 2:4
// pack the same way, expanding each row from its two kept slots on the
// chip as the TPU kernels' expand_tile does (lowrank_matmul_sq.py:45).
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace lrk {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int NT = 64;          // output columns per tile pass
constexpr int ROW_GROUPS = THREADS / NT;
constexpr int CLUSTER = 8;      // CTAs sharing one row block
constexpr int TARGET_CTAS = 264;  // about two CTAs per SM of an H100
constexpr int SMEM_LIMIT = LRK_SMEM_LIMIT;  // opt-in shared memory per block
                                            // (kernels/build.py)

// Reduction depth staged per step: deeper for the skinny decode blocks,
// where each step's global loads dominate.
template <int BM> struct Depth { static constexpr int KC = BM <= 8 ? 128 : 32; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Weight views.  A factor is a (K, N) matrix, or a stack of them, read
// through a view: branch(n, K, N) moves it to factor n of a stack of
// (K, N) factors, cols(c) by c output columns, and column(j, N, K) gives
// a loader of output column j of a (K, N) factor.  Plain and Dequant
// address a dense row-major factor (row k of column j at k * N + j) and
// are staged row by row (Col::at(k)); Sparse24 a 2:4 pack, which has no
// dense layout, staged a group of 4 rows at a time (Col::group(g)).  A
// staging thread keeps to one column, so a column's scale is read once.
template <typename T> struct Plain {
  static constexpr bool GROUPED = false;  // staged row by row (Col::at)
  const T* v;
  struct Col {
    const T* v;
    size_t ld;
    __device__ __forceinline__ float at(int k) const {
      return to_f32(v[(size_t)k * ld]);
    }
  };
  __device__ __forceinline__ Col column(int j, int N, int) const {
    return {v + j, (size_t)N};
  }
  __device__ __forceinline__ Plain branch(int n, int K, int N) const {
    return {v + (size_t)n * K * N};
  }
  __device__ __forceinline__ Plain cols(int c) const { return {v + c}; }
};

template <typename T, typename Q> struct Dequant {
  static constexpr bool GROUPED = false;
  const Q* v;
  const float* scale;   // one f32 per output column
  struct Col {
    const Q* v;
    size_t ld;
    float s;
    __device__ __forceinline__ float at(int k) const {
      return to_f32(from_f32<T>(to_f32(v[(size_t)k * ld]) * s));
    }
  };
  __device__ __forceinline__ Col column(int j, int N, int) const {
    return {v + j, (size_t)N, scale[j]};
  }
  __device__ __forceinline__ Dequant branch(int n, int K, int N) const {
    return {v + (size_t)n * K * N, scale + (size_t)n * N};
  }
  __device__ __forceinline__ Dequant cols(int c) const {
    return {v + c, scale + c};
  }
};

// A (K, N) factor packed 2:4 along K, slot-major as the reference packs
// it (repro/quant/sparse.py): sp (2, K/4, N) int8 or e4m3 kept values,
// idx (2, K/4) int8 within-group row positions, scale (N) f32.  Row 4g+t
// of column j is round_T(v * scale[j]), v the sum in f32 of the slots i
// whose idx[i][g] == t (sp[i][g][j], one slot for a pack made by
// sparsify_array), as expand_tile's where-sum does, and exactly 0 where
// no slot holds it: a pruned row is an explicit zero in the product, as
// in the reference, so a non-finite activation meeting it still spreads.
// A group's four rows come from two value and two index loads.  Per
// branch the pack moves by K*N/2 values, K/2 indices and N scales.
template <typename T, typename Q> struct Sparse24 {
  static constexpr bool GROUPED = true;   // staged a group of 4 rows at once
  const Q* sp;
  const int8_t* idx;
  const float* scale;
  struct Col {
    const Q* sp;
    const int8_t* idx;
    size_t ld;     // N: the row stride of one slot's (K/4, N) tile
    int G;         // K/4 groups per slot
    float s;
    // rows 4g .. 4g+3 of this column, from the group's two kept values
    __device__ __forceinline__ void group(int g, float (&w)[4]) const {
      const int i0 = idx[g], i1 = idx[G + g];
      const float v0 = to_f32(sp[(size_t)g * ld]);
      const float v1 = to_f32(sp[(size_t)(G + g) * ld]);
#pragma unroll
      for (int t = 0; t < 4; ++t)
        w[t] = to_f32(from_f32<T>(
            ((i0 == t ? v0 : 0.f) + (i1 == t ? v1 : 0.f)) * s));
    }
  };
  __device__ __forceinline__ Col column(int j, int N, int K) const {
    return {sp + j, idx, (size_t)N, K / 4, scale[j]};
  }
  __device__ __forceinline__ Sparse24 branch(int n, int K, int N) const {
    return {sp + (size_t)n * K / 2 * N, idx + (size_t)n * K / 2,
            scale + (size_t)n * N};
  }
  __device__ __forceinline__ Sparse24 cols(int c) const {
    return {sp + c, idx, scale + c};
  }
};

template <typename T, int BM>
__host__ __device__ constexpr size_t staging_bytes() {
  return (size_t)(BM * Depth<BM>::KC + Depth<BM>::KC * NT) * sizeof(float);
}

// acc[i] += sum_{k<K} A(rg + 4i, k) * B(k, col) with col = tid % NT and
// rg = tid / NT.  A(r, k) = A[r * lda + k], zero for r >= a_rows;
// B(k, j) = row k of B.column(j, ldb, K), zero for j >= ncols (>= 1).
// Both are staged through shared memory (As, Bs) in f32, KC reduction
// steps at a time; a thread stages B's column col only.
template <typename T, int BM, typename WV>
__device__ __forceinline__ void tile_accumulate(
    float (&acc)[BM / ROW_GROUPS], const T* A, int lda, int a_rows,
    WV B, int ldb, int ncols, int K, float* As, float* Bs) {
  constexpr int KC = Depth<BM>::KC;
  static_assert((BM * KC) % THREADS == 0 && (KC * NT) % THREADS == 0,
                "staging loops assume whole passes");
  static_assert(THREADS % NT == 0, "a thread stages one column of B");
  const int tid = threadIdx.x;
  const int col = tid % NT;
  const int rg = tid / NT;
  const auto Bcol = B.column(min(col, ncols - 1), ldb, K);
  for (int k0 = 0; k0 < K; k0 += KC) {
#pragma unroll
    for (int p = 0; p < BM * KC / THREADS; ++p) {
      const int e = tid + p * THREADS;
      const int r = e / KC, kk = e % KC;
      As[e] = (r < a_rows && k0 + kk < K)
                  ? to_f32(A[(size_t)r * lda + k0 + kk]) : 0.f;
    }
    if constexpr (WV::GROUPED) {
      // a thread stages whole groups of 4 rows of its column (K and k0
      // are multiples of 4, so a group is wholly inside or outside K)
#pragma unroll
      for (int q = 0; q < KC / (4 * ROW_GROUPS); ++q) {
        const int kk = 4 * (rg + ROW_GROUPS * q);
        float w[4] = {0.f, 0.f, 0.f, 0.f};
        if (k0 + kk < K && col < ncols) Bcol.group((k0 + kk) >> 2, w);
#pragma unroll
        for (int t = 0; t < 4; ++t) Bs[(kk + t) * NT + col] = w[t];
      }
    } else {
#pragma unroll
      for (int p = 0; p < KC * NT / THREADS; ++p) {
        const int e = tid + p * THREADS;
        const int kk = e / NT, j = e % NT;
        Bs[e] = (k0 + kk < K && j < ncols) ? Bcol.at(k0 + kk) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      const float b = Bs[kk * NT + col];
#pragma unroll
      for (int i = 0; i < BM / ROW_GROUPS; ++i)
        acc[i] += As[(rg + ROW_GROUPS * i) * KC + kk] * b;
    }
    __syncthreads();
  }
}

// This CTA's slice [j0, j1) of an intermediate H (BM rows, row stride
// ldh) whose column space is `nseg` segments of width RS:
//   H[:, n*RS + c] = round_T( A_n @ B_n[:, c] ),
//   A_n = A + n*a_seg (row stride lda, a_rows valid rows),
//   B_n = factor n of B, a stack of (K, RS) factors.
// A tile never straddles two segments.
template <typename T, int BM, typename WV>
__device__ void slice_product(T* H, int ldh, int j0, int j1, int RS,
                              const T* A, int lda, size_t a_seg, int a_rows,
                              WV B, int K, float* As, float* Bs) {
  const int col = threadIdx.x % NT;
  const int rg = threadIdx.x / NT;
  for (int j = j0; j < j1;) {
    const int n = j / RS, c = j % RS;
    const int width = min(NT, min(j1 - j, RS - c));
    float acc[BM / ROW_GROUPS] = {};
    tile_accumulate<T, BM>(acc, A + n * a_seg, lda, a_rows,
                           B.branch(n, K, RS).cols(c), RS, width, K, As,
                           Bs);
    if (col < width) {
#pragma unroll
      for (int i = 0; i < BM / ROW_GROUPS; ++i)
        H[(size_t)(rg + ROW_GROUPS * i) * ldh + j + col] = from_f32<T>(acc[i]);
    }
    j += width;
  }
}

// Copy every other cluster rank's slice [q*W, q*W + W) of H (BM rows,
// L columns, row stride L) out of its shared memory into ours.
template <typename T, int BM>
__device__ void gather_slices(cg::cluster_group& cluster, T* H, int L,
                              int W) {
  const unsigned rank = cluster.block_rank();
  for (int q = 0; q < CLUSTER; ++q) {
    if (q == (int)rank) continue;
    const int q0 = min(L, q * W), w = min(L, q0 + W) - q0;
    if (w <= 0) continue;
    const T* remote = cluster.map_shared_rank(H, q);
    for (int e = threadIdx.x; e < BM * w; e += THREADS) {
      const int r = e / w, c = q0 + e % w;
      H[(size_t)r * L + c] = remote[(size_t)r * L + c];
    }
  }
}

// y[row0 + r, s0 + j] = round_T( sum_n H_n @ W_n[:, s0 + j] ) for the
// output tiles this CTA owns (tile t goes to CTA t mod gridDim.x of the
// row block); H_n = H + n*RS (row stride ldh), W_n = factor n of Wt, a
// stack of (RS, S) factors.  One f32 accumulator carries the sum over
// segments.
template <typename T, int BM, typename WV>
__device__ void output_tiles(T* y, int row0, int a_rows, int S,
                             const T* H, int ldh, int RS, int nseg,
                             WV Wt, float* As, float* Bs) {
  const int col = threadIdx.x % NT;
  const int rg = threadIdx.x / NT;
  const int n_tiles = (S + NT - 1) / NT;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int s0 = t * NT;
    const int width = min(NT, S - s0);
    float acc[BM / ROW_GROUPS] = {};
    for (int n = 0; n < nseg; ++n)
      tile_accumulate<T, BM>(acc, H + n * RS, ldh, BM,
                             Wt.branch(n, RS, S).cols(s0), S, width, RS, As,
                             Bs);
    if (col < width) {
#pragma unroll
      for (int i = 0; i < BM / ROW_GROUPS; ++i) {
        const int r = rg + ROW_GROUPS * i;
        if (r < a_rows)
          y[(size_t)(row0 + r) * S + s0 + col] = from_f32<T>(acc[i]);
      }
    }
  }
}

// y = (x @ w0) @ w1 for this CTA's row block (blockIdx.y) and its share
// of the S tiles.  Stage 1: this CTA's 1/CLUSTER slice of h = x_blk @ w0,
// rounded to T, gathered across the cluster.  Stage 2: y tiles = h @ w1.
template <typename T, int BM, typename W0, typename W1>
__device__ void lowrank_chain(unsigned char* smem_raw, const T* x, W0 w0,
                              W1 w1, T* y, int M, int C, int R, int S) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  float* As = reinterpret_cast<float*>(smem_raw);
  float* Bs = As + BM * Depth<BM>::KC;
  T* h = reinterpret_cast<T*>(Bs + Depth<BM>::KC * NT);  // (BM, R)

  const int row0 = blockIdx.y * BM;
  const int a_rows = min(BM, M - row0);

  const int W = (R + CLUSTER - 1) / CLUSTER;
  const int j0 = min(R, rank * W), j1 = min(R, j0 + W);
  slice_product<T, BM>(h, R, j0, j1, R, x + (size_t)row0 * C, C, 0, a_rows,
                       w0, C, As, Bs);
  cluster.sync();
  gather_slices<T, BM>(cluster, h, R, W);
  cluster.sync();  // h complete here, and no CTA leaves while read remotely

  output_tiles<T, BM>(y, row0, a_rows, S, h, R, R, 1, w1, As, Bs);
}

// y = sum_n ((x @ u_n) @ xc_n) @ v_n for this CTA's row block:
//   stage 1: h1_n = round_T(x_blk @ u_n), the cluster's CTAs splitting
//            the N*r1 columns, gathered into one BM x N*r1 tile per CTA;
//   stage 2: h2_n = round_T(h1_n @ xc_n) the same way into BM x N*r2;
//   stage 3: y tiles = sum_n h2_n @ v_n in ONE f32 accumulator.
template <typename T, int BM, typename WU, typename WX, typename WV>
__device__ void branched_chain(unsigned char* smem_raw, const T* x, WU u,
                               WX xc, WV v, T* y, int M, int C, int N,
                               int R1, int R2, int S) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  float* As = reinterpret_cast<float*>(smem_raw);
  float* Bs = As + BM * Depth<BM>::KC;
  const int LA = N * R1, LB = N * R2;
  T* hA = reinterpret_cast<T*>(Bs + Depth<BM>::KC * NT);  // (BM, N*r1)
  T* hB = hA + (size_t)BM * LA;                             // (BM, N*r2)

  const int row0 = blockIdx.y * BM;
  const int a_rows = min(BM, M - row0);

  const int W1 = (LA + CLUSTER - 1) / CLUSTER;
  slice_product<T, BM>(hA, LA, min(LA, rank * W1), min(LA, rank * W1 + W1),
                       R1, x + (size_t)row0 * C, C, 0, a_rows, u, C, As,
                       Bs);
  cluster.sync();
  gather_slices<T, BM>(cluster, hA, LA, W1);
  __syncthreads();

  const int W2 = (LB + CLUSTER - 1) / CLUSTER;
  slice_product<T, BM>(hB, LB, min(LB, rank * W2), min(LB, rank * W2 + W2),
                       R2, hA, LA, R1, BM, xc, R1, As, Bs);
  cluster.sync();
  gather_slices<T, BM>(cluster, hB, LB, W2);
  cluster.sync();  // hB complete, and no CTA leaves while read remotely

  output_tiles<T, BM>(y, row0, a_rows, S, hB, LB, R2, N, v, As, Bs);
}

template <typename T, int BM>
size_t lowrank_smem(int R) {
  return staging_bytes<T, BM>() + (size_t)BM * R * sizeof(T);
}

template <typename T, int BM>
size_t branched_smem(int N, int R1, int R2) {
  return staging_bytes<T, BM>() + (size_t)BM * N * (R1 + R2) * sizeof(T);
}

// Grid of (CLUSTER * groups, row blocks): enough clusters per row block
// to cover the output tiles, capped so the whole grid stays near
// TARGET_CTAS (each extra cluster recomputes the row block's
// intermediates).
inline dim3 chain_grid(int M, int S, int BM) {
  const int row_blocks = (M + BM - 1) / BM;
  const int n_tiles = (S + NT - 1) / NT;
  const int want = (n_tiles + CLUSTER - 1) / CLUSTER;
  const int cap = (TARGET_CTAS + CLUSTER * row_blocks - 1) /
                  (CLUSTER * row_blocks);
  const int groups = want < cap ? want : cap;
  return dim3(CLUSTER * (groups > 0 ? groups : 1), row_blocks);
}

// Row block heights the chain kernels are instantiated for (dtype: 0 =
// float32, 1 = bfloat16).  The wrapper picks one per launch from the
// shared memory each would need (kernels/build.py chain_bm): 32 rows
// where M > 8 and the 32-row intermediates fit, else 8 -- wide ranks (a
// branched o projection of 4 x 480, an unembed of 4 x 608) fit only at 8
// rows -- and, for f32 only, 4 where even 8 rows do not fit (a branched
// chain of 4 x 768 or 4 x 960 needs 233,472 or 282,624 B at 8 rows,
// 133,120 or 157,696 B at 4).  bf16 chains run the split-phase kernels;
// their cluster kernels are kept at 8 and 32 rows only.
inline bool known_bm(int bm, int dtype) {
  return bm == 8 || bm == 32 || (bm == 4 && dtype == 0);
}

// Opt a kernel into `smem` bytes of dynamic shared memory and launch it
// on the chain grid; returns the launch's cudaError_t.
template <typename Kernel, typename... Args>
int launch_chain(Kernel kernel, size_t smem, int M, int S, int BM,
                 cudaStream_t stream, Args... args) {
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<chain_grid(M, S, BM), THREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace lrk
