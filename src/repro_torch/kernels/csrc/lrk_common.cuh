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
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lrk {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int NT = 64;          // output columns per tile pass
constexpr int ROW_GROUPS = THREADS / NT;
constexpr int CLUSTER = 8;      // CTAs sharing one row block
constexpr int TARGET_CTAS = 264;  // about two CTAs per SM of an H100
constexpr int SMEM_LIMIT = 232448;  // opt-in shared memory per block

// Reduction depth staged per step: deeper for the skinny decode blocks,
// where each step's global loads dominate.
template <int BM> struct Depth { static constexpr int KC = BM <= 8 ? 128 : 32; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int BM>
__host__ __device__ constexpr size_t staging_bytes() {
  return (size_t)(BM * Depth<BM>::KC + Depth<BM>::KC * NT) * sizeof(float);
}

// acc[i] += sum_{k<K} A(rg + 4i, k) * B(k, col) with col = tid % NT and
// rg = tid / NT.  A(r, k) = A[r * lda + k], zero for r >= a_rows;
// B(k, j) = B[k * ldb + j], zero for j >= ncols.  Both are staged through
// shared memory (As, Bs) in f32, KC reduction steps at a time.
template <typename T, int BM>
__device__ __forceinline__ void tile_accumulate(
    float (&acc)[BM / ROW_GROUPS], const T* A, int lda, int a_rows,
    const T* B, int ldb, int ncols, int K, float* As, float* Bs) {
  constexpr int KC = Depth<BM>::KC;
  static_assert((BM * KC) % THREADS == 0 && (KC * NT) % THREADS == 0,
                "staging loops assume whole passes");
  const int tid = threadIdx.x;
  const int col = tid % NT;
  const int rg = tid / NT;
  for (int k0 = 0; k0 < K; k0 += KC) {
#pragma unroll
    for (int p = 0; p < BM * KC / THREADS; ++p) {
      const int e = tid + p * THREADS;
      const int r = e / KC, kk = e % KC;
      As[e] = (r < a_rows && k0 + kk < K)
                  ? to_f32(A[(size_t)r * lda + k0 + kk]) : 0.f;
    }
#pragma unroll
    for (int p = 0; p < KC * NT / THREADS; ++p) {
      const int e = tid + p * THREADS;
      const int kk = e / NT, j = e % NT;
      Bs[e] = (k0 + kk < K && j < ncols)
                  ? to_f32(B[(size_t)(k0 + kk) * ldb + j]) : 0.f;
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
//   B_n = B + n*b_seg (K x RS, row stride RS).
// A tile never straddles two segments.
template <typename T, int BM>
__device__ void slice_product(T* H, int ldh, int j0, int j1, int RS,
                              const T* A, int lda, size_t a_seg, int a_rows,
                              const T* B, size_t b_seg, int K,
                              float* As, float* Bs) {
  const int col = threadIdx.x % NT;
  const int rg = threadIdx.x / NT;
  for (int j = j0; j < j1;) {
    const int n = j / RS, c = j % RS;
    const int width = min(NT, min(j1 - j, RS - c));
    float acc[BM / ROW_GROUPS] = {};
    tile_accumulate<T, BM>(acc, A + n * a_seg, lda, a_rows,
                           B + n * b_seg + c, RS, width, K, As, Bs);
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
// row block); H_n = H + n*RS (row stride ldh), W_n = Wt + n*RS*S.  One
// f32 accumulator carries the sum over segments.
template <typename T, int BM>
__device__ void output_tiles(T* y, int row0, int a_rows, int S,
                             const T* H, int ldh, int RS, int nseg,
                             const T* Wt, float* As, float* Bs) {
  const int col = threadIdx.x % NT;
  const int rg = threadIdx.x / NT;
  const int n_tiles = (S + NT - 1) / NT;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int s0 = t * NT;
    const int width = min(NT, S - s0);
    float acc[BM / ROW_GROUPS] = {};
    for (int n = 0; n < nseg; ++n)
      tile_accumulate<T, BM>(acc, H + n * RS, ldh, BM,
                             Wt + (size_t)n * RS * S + s0, S, width, RS,
                             As, Bs);
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

}  // namespace lrk
