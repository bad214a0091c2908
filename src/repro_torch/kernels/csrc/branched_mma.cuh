// The split-phase chain kernels (sm_90a), on bf16 activations:
//   branched_mma_kernel: y = sum_n ((x @ W(u)_n) @ W(xc)_n) @ W(v)_n, three
//     phases (branched_matmul.cu's note describes the design);
//   lowrank_mma_kernel:  y = (x @ W(w0)) @ W(w1), the same core in two
//     phases (lowrank_matmul_sq.cu's note);
// W each factor's weight view of mma_chain.cuh: PlainB (bf16 factors,
// branched_matmul.cu and lowrank_matmul.cu), DequantB (int8 / e4m3 with
// scales, branched_matmul_q.cu and lowrank_matmul_q.cu), Sparse24B (2:4
// packs, branched_matmul_sq.cu and lowrank_matmul_sq.cu).  Each source
// instantiates a kernel with its views; SplitLaunch is the grid, shared
// memory and cooperative launch of both.
#pragma once

#include <cooperative_groups.h>

#include "mma_chain.cuh"

namespace mmac {

namespace cg = cooperative_groups;

// One phase of the split-phase kernel, every CTA of the grid taking items
// w = blockIdx.x, blockIdx.x + gridDim.x, ...:
//   out[:, n*NC + c] = round_bf16( A_n @ W_n )[:, c],  n < nbr, c < NC,
//   A_n = A + n*a_br (rows x K, row stride lda), W_n = W.branch(n) (K x NC).
// Item w is (K slice q, branch n, 128-column tile t) with
// q = w / (nbr*tiles), n = (w / tiles) % nbr, t = w % tiles -- the order
// branched_split.items() lists them.  With one K slice a tile is rounded
// and stored in out; with several, each item stores its f32 partial in P
// (slice q at q * pslice, row stride ldo), and after a grid sync every
// thread of the grid sums a stride of the slices in order into out.
// Ends on a grid sync (out complete) unless `last`.
template <int MT, typename WV>
__device__ __forceinline__ void run_phase(
    cg::grid_group& grid, const bf16* A, int lda, size_t a_br, const WV& W,
    int K, int NC, int nbr, int kslice, bf16* out, int ldo, float* P,
    size_t pslice, int rows, unsigned char* smem, bool last) {
  const int tiles = cdiv(NC, BN);
  const int nslices = cdiv(K, kslice);
  float acc[MT][2][4];
  for (int w = blockIdx.x; w < nslices * nbr * tiles; w += gridDim.x) {
    const int q = w / (nbr * tiles), n = (w / tiles) % nbr;
    const int c0 = (w % tiles) * BN, kb = q * kslice;
    tile_mma<MT>(acc, A + n * a_br, lda, rows, W.branch(n), c0, NC, kb,
                     min(K, kb + kslice), smem);
    if (nslices == 1)
      store_tile<MT>(acc, out + n * NC + c0, ldo, rows, NC - c0);
    else
      store_tile<MT>(acc, P + q * pslice + n * NC + c0, ldo, rows, NC - c0);
  }
  if (nslices > 1) {
    grid.sync();
    reduce_slices(out, ldo, P, pslice, nslices, rows, ldo, ldo);
  }
  if (!last) grid.sync();
}

// %globaltimer (ns), for the phase timer
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Dynamic shared memory of one instantiation: the largest of its views'
// tiles (the phases run one after the other on the same memory).
template <typename... V>
constexpr size_t split_smem() {
  size_t most = 0;
  ((most = tile_smem<V>() > most ? tile_smem<V>() : most), ...);
  return most;
}

// u / xc / v: the views of the (N, C, R1), (N, R1, R2) and (N, R2, S)
// stacks (R = C, R1 and R2; phase 3 reads v's stack as one (N*R2, S)
// matrix, so its rows change branch every R2).
// Scratch (device memory the wrapper allocates): P, the f32 partials of
// whichever phase is K-sliced (its slices x rows x width), h1 (rows, N*R1)
// and h2 (rows, N*R2) bf16, rows = min(M, BM).  k1 / k2 / k3: the K-slice
// lengths of the three phases (branched_split).  P is free again once a
// phase's reduction has passed the next grid sync, and so are h1 / h2
// once the phase reading them has, so row blocks reuse all three (only
// the last row block's phase 3 skips its closing sync).
// ts: null, or 1 + 3 * row blocks slots that CTA 0 fills with the time at
// the start and at the end of every phase (a grid sync after each).
template <int MT, typename UV, typename XV, typename VV>
__global__ void __launch_bounds__(THREADS, 2)
branched_mma_kernel(const bf16* __restrict__ x, UV u, XV xc, VV v,
                    bf16* __restrict__ y, float* p, bf16* h1, bf16* h2,
                    int M, int C, int N, int R1, int R2, int S, int k1,
                    int k2, int k3, unsigned long long* ts) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int L1 = N * R1, L2 = N * R2;
  const int block_rows = min(M, BM);
  const bool mark = ts != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  if (mark) *ts++ = global_ns();
  for (int row0 = 0; row0 < M; row0 += BM) {
    const int rows = min(BM, M - row0);
    zero_pad_rows<MT>(reinterpret_cast<bf16*>(smem), rows);
    // phase 1: h1[:, n*R1 + c] = round_bf16(x_blk @ W(u)_n)
    run_phase<MT>(grid, x + (size_t)row0 * C, C, 0, u, C, R1, N, k1, h1,
                      L1, p, (size_t)block_rows * L1, rows, smem, false);
    if (mark) *ts++ = global_ns();
    // phase 2: h2[:, n*R2 + c] = round_bf16(h1_n @ W(xc)_n)
    run_phase<MT>(grid, h1, L1, R1, xc, R1, R2, N, k2, h2, L2, p,
                      (size_t)block_rows * L2, rows, smem, false);
    if (mark) *ts++ = global_ns();
    // phase 3: y_blk = round_bf16(h2 @ W(v)), v read as one (N*R2, S)
    // matrix
    run_phase<MT>(grid, h2, L2, 0, v, L2, S, 1, k3,
                      y + (size_t)row0 * S, S, p, (size_t)block_rows * S,
                      rows, smem, ts == nullptr && row0 + BM >= M);
    if (mark) *ts++ = global_ns();
  }
}

// The two-phase lowrank chain kernel on bf16 activations:
//   y = round_bf16( round_bf16(x @ W(w0)) @ W(w1) )
// w0 / w1: the views of the (C, R) and (R, S) factors (one branch each).
// Per row block of up to BM rows, two calls of run_phase:
//   phase 1: h = round_bf16(x_blk @ W(w0)), K = C, width R;
//   phase 2: y_blk = round_bf16(h @ W(w1)), K = R, width S.
// Scratch (the wrapper allocates it): P, the f32 partials of whichever
// phase is K-sliced, and h (rows, R) bf16, rows = min(M, BM), both reused
// by every row block as in branched_mma_kernel.  k1 / k2: the K-slice
// lengths (lowrank_split).  ts: null, or 1 + 2 * row blocks slots that
// CTA 0 fills with the time at the start and at the end of every phase.
template <int MT, typename W0V, typename W1V>
__global__ void __launch_bounds__(THREADS, 2)
lowrank_mma_kernel(const bf16* __restrict__ x, W0V w0, W1V w1,
                   bf16* __restrict__ y, float* p, bf16* h, int M, int C,
                   int R, int S, int k1, int k2, unsigned long long* ts) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int block_rows = min(M, BM);
  const bool mark = ts != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  if (mark) *ts++ = global_ns();
  for (int row0 = 0; row0 < M; row0 += BM) {
    const int rows = min(BM, M - row0);
    zero_pad_rows<MT>(reinterpret_cast<bf16*>(smem), rows);
    run_phase<MT>(grid, x + (size_t)row0 * C, C, 0, w0, C, R, 1, k1, h, R,
                  p, (size_t)block_rows * R, rows, smem, false);
    if (mark) *ts++ = global_ns();
    run_phase<MT>(grid, h, R, 0, w1, R, S, 1, k2, y + (size_t)row0 * S, S,
                  p, (size_t)block_rows * S, rows, smem,
                  ts == nullptr && row0 + BM >= M);
    if (mark) *ts++ = global_ns();
  }
}

// The split-phase kernel of a list of weight views: three views, the
// branched chain; two, the lowrank chain.
template <int MT, typename... V>
struct SplitKernel;
template <int MT, typename UV, typename XV, typename VV>
struct SplitKernel<MT, UV, XV, VV> {
  static const void* fn() {
    return (const void*)branched_mma_kernel<MT, UV, XV, VV>;
  }
};
template <int MT, typename W0V, typename W1V>
struct SplitKernel<MT, W0V, W1V> {
  static const void* fn() {
    return (const void*)lowrank_mma_kernel<MT, W0V, W1V>;
  }
};

// Row tiles of 16 the kernels are instantiated with for a block of `rows`.
inline int row_tiles(int rows) { return rows <= 16 ? 1 : rows <= 32 ? 2 : 4; }

// Grid, shared memory and cooperative launch of a persistent kernel K:
// K::SMEM bytes of dynamic shared memory, K::fn<MT>() the kernel at MT
// row tiles of 16, THREADS threads a CTA.  The split-phase chain kernels
// below (SplitLaunch) and the int8 x int8 chain of qa_mma.cuh launch
// through it.
template <typename K>
struct CoopLaunch {
  // The persistent grid of the instantiation at MT row tiles on the
  // current device: co-resident CTAs per SM (at its shared memory) x
  // SMs.  Opts the kernel into its dynamic shared memory first; cached
  // per instantiation and device (each has its own registers, so its own
  // occupancy).
  template <int MT>
  static int grid_of(int* grid) {
    constexpr int MAX_DEVICES = 64;
    static int cached[MAX_DEVICES] = {};
    const void* kernel = K::template fn<MT>();
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES && cached[dev] > 0) {
      *grid = cached[dev];
      return 0;
    }
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::SMEM);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, K::SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm * sms <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
    if (dev < MAX_DEVICES) cached[dev] = per_sm * sms;
    *grid = per_sm * sms;
    return 0;
  }

  // The persistent grid (CTAs) of the instantiation a row block of `rows`
  // rows takes, or minus the cudaError_t.
  static int grid(int rows) {
    int g = 0, rc;
    switch (row_tiles(rows)) {
      case 1: rc = grid_of<1>(&g); break;
      case 2: rc = grid_of<2>(&g); break;
      default: rc = grid_of<4>(&g); break;
    }
    return rc != 0 ? -rc : g;
  }

  // One cooperative launch at MT row tiles on at most `ctas` CTAs of the
  // persistent grid (0: all of them); `args` are the kernel's arguments,
  // each of its parameter's size.
  template <int MT, typename... A>
  static int launch_of(int ctas, cudaStream_t stream, A... args) {
    int grid = 0;
    const int rc = grid_of<MT>(&grid);
    if (rc != 0) return rc;
    if (ctas > 0 && ctas < grid) grid = ctas;
    void* ptrs[] = {&args...};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        K::template fn<MT>(), dim3(grid), dim3(THREADS), ptrs, K::SMEM,
        stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }

  // One cooperative launch for M rows on at most `ctas` CTAs (0: the
  // whole persistent grid); returns its cudaError_t.
  template <typename... A>
  static int launch(int M, int ctas, cudaStream_t stream, A... args) {
    switch (row_tiles(M < BM ? M : BM)) {
      case 1: return launch_of<1>(ctas, stream, args...);
      case 2: return launch_of<2>(ctas, stream, args...);
      default: return launch_of<4>(ctas, stream, args...);
    }
  }
};

// The split-phase kernel of views V... as a CoopLaunch kernel.
template <typename... V>
struct SplitKernels {
  static constexpr size_t SMEM = split_smem<V...>();
  template <int MT>
  static const void* fn() {
    return SplitKernel<MT, V...>::fn();
  }
};

// Grid, shared memory and launch of the split-phase kernel of views V...
template <typename... V>
using SplitLaunch = CoopLaunch<SplitKernels<V...>>;

template <typename... V>
int split_grid(int rows) {
  return SplitLaunch<V...>::grid(rows);
}

// One cooperative launch of the branched split-phase kernel for M rows;
// returns the launch's cudaError_t (0 on success).
template <typename UV, typename XV, typename VV>
int launch_split(const void* x, UV u, XV xc, VV v, void* y, void* p,
                 void* h1, void* h2, int M, int C, int N, int R1, int R2,
                 int S, int k1, int k2, int k3, void* ts,
                 cudaStream_t stream) {
  if (M <= 0 || C <= 0 || N <= 0 || R1 <= 0 || R2 <= 0 || S <= 0 ||
      k1 <= 0 || k2 <= 0 || k3 <= 0)
    return (int)cudaErrorInvalidValue;
  return SplitLaunch<UV, XV, VV>::launch(M, 0, stream, x, u, xc, v, y, p,
                                         h1, h2, M, C, N, R1, R2, S, k1, k2,
                                         k3, ts);
}

// One cooperative launch of the lowrank split-phase kernel for M rows on
// at most `ctas` CTAs (0: the whole persistent grid); returns the
// launch's cudaError_t (0 on success).
template <typename W0V, typename W1V>
int launch_lowrank(const void* x, W0V w0, W1V w1, void* y, void* p, void* h,
                   int M, int C, int R, int S, int k1, int k2, int ctas,
                   void* ts, cudaStream_t stream) {
  if (M <= 0 || C <= 0 || R <= 0 || S <= 0 || k1 <= 0 || k2 <= 0 ||
      ctas < 0)
    return (int)cudaErrorInvalidValue;
  return SplitLaunch<W0V, W1V>::launch(M, ctas, stream, x, w0, w1, y, p, h,
                                       M, C, R, S, k1, k2, ts);
}

}  // namespace mmac
