// Branched (block-diagonal) low-rank matmul for Hopper (sm_90a):
//   y = sum_n ((x @ u_n) @ xc_n) @ v_n        (paper Eq. 17, Fig. 4)
//
// Replaces the TPU kernel src/repro/kernels/branched_matmul.py
// (branched_matmul, pl.pallas_call at :69).  Its grid is (M/bm, S/bn, N)
// with the branch axis innermost and in order, each step adding one
// branch's contribution to an f32 VMEM accumulator.  GPU blocks run in no
// order, so the branch sum cannot ride the grid.
//
// What bounds it on an H100: the weight bytes, N*(C*r1 + r1*r2 + r2*S).
// At decode (M = 8) the products do 16 FLOPs per weight byte (bf16), far
// below the ~295 at which the tensor cores become the limit; at a
// prefill chunk (M = 64) 64 FLOPs per byte, still bound by bytes, but
// past what CUDA-core FMAs sustain.  So the design must stream every
// weight byte once, from all 132 SMs at once, into tensor cores.
//
// bf16: branched_mma_kernel, one cooperative launch of a persistent grid
// (occupancy x SMs CTAs: 264 on an H100), three phases over the whole card
// separated by grid syncs, per row block of up to 64 rows (M > 64 loops
// over blocks and reads the weights once per block):
//   phase 1: h1 = round_bf16(x_blk @ u_n) for every branch n;
//   phase 2: h2 = round_bf16(h1_n @ xc_n);
//   phase 3: y_blk = round_bf16(h2 @ v), v read as one (N*r2, S) matrix.
// A phase's work items are (K slice, branch, 128-column tile).  An SM's
// cp.async ring streams no faster than its share of the card's 3.35 TB/s
// (25 GB/s), so every phase, even phase 2's 1-3 MB, must spread over all
// SMs: each slices its reduction axis so that it has about two
// items per SM (kernels/branched_matmul.py::branched_split).  A phase
// with several slices stores f32 partials and then, after a grid sync,
// sums them in slice order into its bf16 output, every thread of the grid
// taking a stride.  Each tile is mma_chain.cuh's core: a 6-stage cp.async
// ring, ldmatrix, mma.sync m16n8k16 bf16 -> f32.  Partials are added in a
// fixed order and nothing uses atomics, so a call gives the same bits
// every run.  The roundings are the TPU kernel's (branched_matmul.py:
// 37-39): h1 and h2 to bf16 once after their full f32 sum, y one f32 sum
// over every branch.
//
// f32: the cluster design below (branched_kernel), kept because TF32 tensor
// cores cannot reach f32's tolerance: a thread block cluster of CLUSTER
// CTAs shares one row block.
//   stage 1: every branch's h1_n = round_T(x_blk @ u_n), the CTAs splitting
//            the N*r1 columns between them, gathered over distributed
//            shared memory into one BM x N*r1 tile per CTA;
//   stage 2: h2_n = round_T(h1_n @ xc_n) the same way into BM x N*r2;
//   stage 3: each CTA walks its S tiles accumulating sum_n h2_n @ v_n[:, tile]
//            in ONE f32 accumulator.
// Its bf16 instantiation stays callable as a yardstick (chip_smoke's
// prev_ms); the wrapper never launches it for bf16.
#include "lrk_common.cuh"
#include "mma_chain.cuh"

namespace lrk {

template <typename T, int BM>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
branched_kernel(const T* __restrict__ x, const T* __restrict__ u,
                const T* __restrict__ xc, const T* __restrict__ v,
                T* __restrict__ y, int M, int C, int N, int R1, int R2,
                int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  branched_chain<T, BM>(smem_raw, x, Plain<T>{u}, Plain<T>{xc}, Plain<T>{v},
                        y, M, C, N, R1, R2, S);
}

template <typename T, int BM>
int launch_branched(const void* x, const void* u, const void* xc,
                    const void* v, void* y, int M, int C, int N, int R1,
                    int R2, int S, cudaStream_t stream) {
  return launch_chain(branched_kernel<T, BM>, branched_smem<T, BM>(N, R1, R2),
                      M, S, BM, stream, static_cast<const T*>(x),
                      static_cast<const T*>(u), static_cast<const T*>(xc),
                      static_cast<const T*>(v), static_cast<T*>(y), M, C, N,
                      R1, R2, S);
}

// ---------------------------------------------------------------------------
// bf16: the split-phase tensor-core kernel
// ---------------------------------------------------------------------------

// One phase of the split-phase kernel, every CTA of the grid taking items
// w = blockIdx.x, blockIdx.x + gridDim.x, ...:
//   out[:, n*NC + c] = round_bf16( A_n @ W_n )[:, c],  n < nbr, c < NC,
//   A_n = A + n*a_br (rows x K, row stride lda), W_n = W + n*w_br (K x NC,
//   row stride ldw).
// Item w is (K slice q, branch n, 128-column tile t) with
// q = w / (nbr*tiles), n = (w / tiles) % nbr, t = w % tiles -- the order
// branched_split.items() lists them.  With one K slice a tile is rounded
// and stored in out; with several, each item stores its f32 partial in P
// (slice q at q * pslice, row stride ldo), and after a grid sync every
// thread of the grid sums a stride of the slices in order into out.
// Ends on a grid sync (out complete) unless `last`.
template <int MT>
__device__ __forceinline__ void run_phase(
    cg::grid_group& grid, const __nv_bfloat16* A, int lda, size_t a_br,
    const __nv_bfloat16* W, size_t w_br, int ldw, int K, int NC, int nbr,
    int kslice, __nv_bfloat16* out, int ldo, float* P, size_t pslice,
    int rows, __nv_bfloat16* smem, bool last) {
  const int tiles = mmac::cdiv(NC, mmac::BN);
  const int nslices = mmac::cdiv(K, kslice);
  float acc[MT][2][4];
  for (int w = blockIdx.x; w < nslices * nbr * tiles; w += gridDim.x) {
    const int q = w / (nbr * tiles), n = (w / tiles) % nbr;
    const int c0 = (w % tiles) * mmac::BN, kb = q * kslice;
    mmac::tile_mma<MT>(acc, A + n * a_br, lda, rows,
                       mmac::PlainB{W + n * w_br, ldw}, c0, NC, kb,
                       min(K, kb + kslice), smem);
    if (nslices == 1)
      mmac::store_tile<MT>(acc, out + n * NC + c0, ldo, rows, NC - c0);
    else
      mmac::store_tile<MT>(acc, P + q * pslice + n * NC + c0, ldo, rows,
                           NC - c0);
  }
  if (nslices > 1) {
    grid.sync();
    mmac::reduce_slices(out, ldo, P, pslice, nslices, rows, ldo, ldo);
  }
  if (!last) grid.sync();
}

// %globaltimer (ns), for the phase timer
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Scratch (device memory the wrapper allocates): P, the f32 partials of
// whichever phase is K-sliced (its slices x rows x width), h1 (rows, N*R1)
// and h2 (rows, N*R2) bf16, rows = min(M, BM).  k1 / k2 / k3: the K-slice
// lengths of the three phases (branched_split).  P is free again once a
// phase's reduction has passed the next grid sync, and so are h1 / h2
// once the phase reading them has, so row blocks reuse all three (only
// the last row block's phase 3 skips its closing sync).
// ts: null, or 1 + 3 * row blocks slots that CTA 0 fills with the time at
// the start and at the end of every phase (a grid sync after each).
template <int MT>
__global__ void __launch_bounds__(mmac::THREADS, 2)
branched_mma_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ u,
                    const __nv_bfloat16* __restrict__ xc,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ y, float* p,
                    __nv_bfloat16* h1, __nv_bfloat16* h2, int M, int C,
                    int N, int R1, int R2, int S, int k1, int k2, int k3,
                    unsigned long long* ts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const int L1 = N * R1, L2 = N * R2;
  const int block_rows = min(M, mmac::BM);
  const bool mark = ts != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  if (mark) *ts++ = global_ns();
  for (int row0 = 0; row0 < M; row0 += mmac::BM) {
    const int rows = min(mmac::BM, M - row0);
    mmac::zero_pad_rows<MT>(smem, rows);
    // phase 1: h1[:, n*R1 + c] = round_bf16(x_blk @ u_n)
    run_phase<MT>(grid, x + (size_t)row0 * C, C, 0, u, (size_t)C * R1, R1,
                  C, R1, N, k1, h1, L1, p, (size_t)block_rows * L1, rows,
                  smem, false);
    if (mark) *ts++ = global_ns();
    // phase 2: h2[:, n*R2 + c] = round_bf16(h1_n @ xc_n)
    run_phase<MT>(grid, h1, L1, R1, xc, (size_t)R1 * R2, R2, R1, R2, N, k2,
                  h2, L2, p, (size_t)block_rows * L2, rows, smem, false);
    if (mark) *ts++ = global_ns();
    // phase 3: y_blk = round_bf16(h2 @ v), v read as one (N*R2, S) matrix
    run_phase<MT>(grid, h2, L2, 0, v, 0, S, L2, S, 1, k3,
                  y + (size_t)row0 * S, S, p, (size_t)block_rows * S, rows,
                  smem, ts == nullptr && row0 + mmac::BM >= M);
    if (mark) *ts++ = global_ns();
  }
}

// The persistent grid of one instantiation on the current device:
// co-resident CTAs per SM (at the kernel's shared memory) x SMs.  Opts the
// kernel into its dynamic shared memory first; cached per device.
template <int MT>
int mma_grid(int* grid) {
  constexpr int MAX_DEVICES = 64;
  static int cached[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < MAX_DEVICES && cached[dev] > 0) {
    *grid = cached[dev];
    return 0;
  }
  err = cudaFuncSetAttribute(branched_mma_kernel<MT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)mmac::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, branched_mma_kernel<MT>, mmac::THREADS, mmac::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm * sms <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (dev < MAX_DEVICES) cached[dev] = per_sm * sms;
  *grid = per_sm * sms;
  return 0;
}

template <int MT>
int launch_mma(const void* x, const void* u, const void* xc, const void* v,
               void* y, void* p, void* h1, void* h2, int M, int C, int N,
               int R1, int R2, int S, int k1, int k2, int k3, void* ts,
               cudaStream_t stream) {
  int grid = 0;
  int rc = mma_grid<MT>(&grid);
  if (rc != 0) return rc;
  void* args[] = {&x, &u, &xc, &v, &y, &p, &h1, &h2, &M, &C, &N,
                  &R1, &R2, &S, &k1, &k2, &k3, &ts};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)branched_mma_kernel<MT>, dim3(grid), dim3(mmac::THREADS),
      args, mmac::SMEM_BYTES, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Row tiles of 16 the kernel is instantiated with for a block of `rows`.
inline int mma_row_tiles(int rows) {
  return rows <= 16 ? 1 : rows <= 32 ? 2 : 4;
}

}  // namespace lrk

extern "C" {

// Shared memory one launch needs (bytes) at a row block of bm rows (8 or
// 32).  dtype: 0 = float32, 1 = bf16.  The quantized kernel
// (branched_matmul_q.cu) needs the same.
size_t lrk_branched_smem(int dtype, int bm, int N, int R1, int R2) {
  if (dtype == 0)
    return bm == 8 ? lrk::branched_smem<float, 8>(N, R1, R2)
                   : lrk::branched_smem<float, 32>(N, R1, R2);
  return bm == 8 ? lrk::branched_smem<__nv_bfloat16, 8>(N, R1, R2)
                 : lrk::branched_smem<__nv_bfloat16, 32>(N, R1, R2);
}

// y (M,S) = sum_n ((x (M,C) @ u[n] (C,R1)) @ xc[n] (R1,R2)) @ v[n] (R2,S);
// u (N,C,R1), xc (N,R1,R2), v (N,R2,S), all row-major contiguous, in row
// blocks of bm rows (8 or 32).  Returns the launch's cudaError_t (0 on
// success).
int lrk_branched_matmul(int dtype, int bm, const void* x, const void* u,
                        const void* xc, const void* v, void* y, int M, int C,
                        int N, int R1, int R2, int S, void* stream) {
  if (!lrk::known_bm(bm)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype == 0)
    return bm == 8 ? lrk::launch_branched<float, 8>(x, u, xc, v, y, M, C, N,
                                                    R1, R2, S, s)
                   : lrk::launch_branched<float, 32>(x, u, xc, v, y, M, C,
                                                     N, R1, R2, S, s);
  if (dtype == 1)
    return bm == 8 ? lrk::launch_branched<bf16, 8>(x, u, xc, v, y, M, C, N,
                                                   R1, R2, S, s)
                   : lrk::launch_branched<bf16, 32>(x, u, xc, v, y, M, C,
                                                    N, R1, R2, S, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the bf16 split-phase kernel (bytes): fixed by
// its tile, whatever the ranks.
size_t lrk_branched_mma_smem(void) { return mmac::SMEM_BYTES; }

// The persistent grid (CTAs) the bf16 split-phase kernel launches with on
// the current device for a row block of `rows` rows, or minus the
// cudaError_t.
int lrk_branched_mma_grid(int rows) {
  int grid = 0, rc;
  switch (lrk::mma_row_tiles(rows)) {
    case 1: rc = lrk::mma_grid<1>(&grid); break;
    case 2: rc = lrk::mma_grid<2>(&grid); break;
    default: rc = lrk::mma_grid<4>(&grid); break;
  }
  return rc != 0 ? -rc : grid;
}

// bf16 y (M,S) = sum_n ((x (M,C) @ u[n] (C,R1)) @ xc[n] (R1,R2)) @ v[n]
// (R2,S) in one cooperative launch of the split-phase kernel; p / h1 / h2
// are the scratch regions branched_split lays out, k1 / k2 / k3 its
// K-slice lengths; ts null, or 1 + 3 * ceil(M / 64) u64 slots for the
// phase timer.  Returns the launch's cudaError_t (0 on success).
int lrk_branched_matmul_mma(const void* x, const void* u, const void* xc,
                            const void* v, void* y, void* p, void* h1,
                            void* h2, int M, int C, int N, int R1, int R2,
                            int S, int k1, int k2, int k3, void* ts,
                            void* stream) {
  if (M <= 0 || C <= 0 || N <= 0 || R1 <= 0 || R2 <= 0 || S <= 0 ||
      k1 <= 0 || k2 <= 0 || k3 <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lrk::mma_row_tiles(M < mmac::BM ? M : mmac::BM)) {
    case 1:
      return lrk::launch_mma<1>(x, u, xc, v, y, p, h1, h2, M, C, N, R1, R2,
                                S, k1, k2, k3, ts, s);
    case 2:
      return lrk::launch_mma<2>(x, u, xc, v, y, p, h1, h2, M, C, N, R1, R2,
                                S, k1, k2, k3, ts, s);
    default:
      return lrk::launch_mma<4>(x, u, xc, v, y, p, h1, h2, M, C, N, R1, R2,
                                S, k1, k2, k3, ts, s);
  }
}

}  // extern "C"
