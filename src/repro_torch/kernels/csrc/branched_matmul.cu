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
// over every branch.  The kernel (branched_mma.cuh) is a template on the
// three factors' weight views: here PlainB;
// the quantized and the 2:4 kernels (branched_matmul_q.cu,
// branched_matmul_sq.cu) run it on their dequantizing and expanding views.
//
// The cluster design below (branched_kernel), the first f32 and bf16
// kernel: a thread block cluster of CLUSTER CTAs shares one row block.
//   stage 1: every branch's h1_n = round_T(x_blk @ u_n), the CTAs splitting
//            the N*r1 columns between them, gathered over distributed
//            shared memory into one BM x N*r1 tile per CTA;
//   stage 2: h2_n = round_T(h1_n @ xc_n) the same way into BM x N*r2;
//   stage 3: each CTA walks its S tiles accumulating sum_n h2_n @ v_n[:, tile]
//            in ONE f32 accumulator.
// Both instantiations stay callable as yardsticks (chip_smoke's prev_ms);
// the wrapper never launches them.  f32 calls take the f32 form
// (chain_f32.cu: one output-tiled, K-sliced split-TF32 mma.sync launch per
// product, over the whole card).
//
// bf16 calls of M >= LARGE_M rows take the large-M form instead
// (chain_wgmma.cuh: one output-tiled wgmma launch per product).
#include "branched_mma.cuh"
#include "lrk_common.cuh"

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

}  // namespace lrk

extern "C" {

// Shared memory one launch needs (bytes) at a row block of bm rows (4, 8
// or 32).  dtype: 0 = float32, 1 = bf16.  The quantized kernel
// (branched_matmul_q.cu) needs the same.
size_t lrk_branched_smem(int dtype, int bm, int N, int R1, int R2) {
  if (dtype == 0)
    return bm == 4   ? lrk::branched_smem<float, 4>(N, R1, R2)
           : bm == 8 ? lrk::branched_smem<float, 8>(N, R1, R2)
                     : lrk::branched_smem<float, 32>(N, R1, R2);
  return bm == 4   ? lrk::branched_smem<__nv_bfloat16, 4>(N, R1, R2)
         : bm == 8 ? lrk::branched_smem<__nv_bfloat16, 8>(N, R1, R2)
                   : lrk::branched_smem<__nv_bfloat16, 32>(N, R1, R2);
}

// y (M,S) = sum_n ((x (M,C) @ u[n] (C,R1)) @ xc[n] (R1,R2)) @ v[n] (R2,S);
// u (N,C,R1), xc (N,R1,R2), v (N,R2,S), all row-major contiguous, in row
// blocks of bm rows (8 or 32; f32 also 4).  Returns the launch's
// cudaError_t (0 on success).
int lrk_branched_matmul(int dtype, int bm, const void* x, const void* u,
                        const void* xc, const void* v, void* y, int M, int C,
                        int N, int R1, int R2, int S, void* stream) {
  if (!lrk::known_bm(bm, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype == 0)
    return bm == 4   ? lrk::launch_branched<float, 4>(x, u, xc, v, y, M, C,
                                                      N, R1, R2, S, s)
           : bm == 8 ? lrk::launch_branched<float, 8>(x, u, xc, v, y, M, C,
                                                      N, R1, R2, S, s)
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
size_t lrk_branched_mma_smem(void) {
  using V = mmac::PlainB;
  return mmac::split_smem<V, V, V>();
}

// The persistent grid (CTAs) the bf16 split-phase kernel launches with on
// the current device for a row block of `rows` rows, or minus the
// cudaError_t.
int lrk_branched_mma_grid(int rows) {
  using V = mmac::PlainB;
  return mmac::split_grid<V, V, V>(rows);
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
  using bf16 = __nv_bfloat16;
  using V = mmac::PlainB;
  return mmac::launch_split(
      x, V{static_cast<const bf16*>(u), R1, C},
      V{static_cast<const bf16*>(xc), R2, R1},
      V{static_cast<const bf16*>(v), S, R2}, y, p, h1, h2, M, C, N, R1, R2,
      S, k1, k2, k3, ts, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
