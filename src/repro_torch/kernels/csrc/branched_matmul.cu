// Branched (block-diagonal) low-rank matmul for Hopper (sm_90a):
//   y = sum_n ((x @ u_n) @ xc_n) @ v_n        (paper Eq. 17, Fig. 4)
//
// Replaces the TPU kernel src/repro/kernels/branched_matmul.py
// (branched_matmul, pl.pallas_call at :69).  Its grid is (M/bm, S/bn, N)
// with the branch axis innermost and in order, each step adding one
// branch's contribution to an f32 VMEM accumulator.  GPU blocks run in no
// order, so the branch sum cannot ride the grid.
//
// What bounds it on an H100: the weight bytes (N*(C*r1 + r1*r2 + r2*S)) at
// decode and at prefill-chunk row counts -- a few FLOPs per byte.
//
// Design: a thread block cluster of CLUSTER CTAs shares one row block.
//   stage 1: every branch's h1_n = round_T(x_blk @ u_n), the CTAs splitting
//            the N*r1 columns between them, gathered over distributed
//            shared memory into one BM x N*r1 tile per CTA;
//   stage 2: h2_n = round_T(h1_n @ xc_n) the same way into BM x N*r2;
//   stage 3: each CTA walks its S tiles accumulating sum_n h2_n @ v_n[:, tile]
//            in ONE f32 accumulator.
// The intermediates round to x's type exactly where the TPU kernel casts
// (branched_matmul.py:37-39); the branch sum is the TPU's f32 sum taken in
// another order (one running sum over all (n, k) products instead of one
// per-branch dot added to the accumulator), so results agree to f32
// rounding, not bit for bit.  Products are plain f32 FMAs; tensor cores
// (wgmma) and TMA are later work.
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

}  // extern "C"
