// Branched low-rank matmul on quantized factors for Hopper (sm_90a):
//   y = sum_n ((x @ dq(u_n)) @ dq(xc_n)) @ dq(v_n)     (paper Eq. 17)
//
// Replaces the TPU kernel src/repro/kernels/branched_matmul_q.py
// (branched_matmul_q, pl.pallas_call at :90): int8 or e4m3 branch
// factors with f32 per-branch per-output-channel scales (u_scale
// (N,1,r1), xc_scale (N,1,r2), v_scale (N,1,S)), dequantized on chip;
// the intermediates and the branch sum never touch device memory.
//
// What bounds it on an H100: the weight bytes, one byte per value
// (N*(C*r1 + r1*r2 + r2*S), plus the scale rows) -- a few FLOPs per byte
// at decode and at prefill-chunk row counts.
//
// Design: the chain of branched_matmul.cu (lrk_common.cuh branched_chain:
// h1 and h2 of every branch in shared memory, shared by an 8-CTA cluster,
// the branch sum in one f32 accumulator per output tile) with every
// weight read through the Dequant view: q * scale rounded to x's type --
// where the TPU kernel casts (branched_matmul_q.py:47-49) -- widened to
// f32 for the FMA.  The scale view moves by r1, r2 or S columns per
// branch with its factor.  Shared memory as branched_matmul at the same
// ranks (lrk_branched_smem).
#include "lrk_common.cuh"

namespace lrk {

template <typename T, typename Q, int BM>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
branched_q_kernel(const T* __restrict__ x, const Q* __restrict__ uq,
                  const float* __restrict__ us, const Q* __restrict__ xcq,
                  const float* __restrict__ xcs, const Q* __restrict__ vq,
                  const float* __restrict__ vs, T* __restrict__ y, int M,
                  int C, int N, int R1, int R2, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  branched_chain<T, BM>(smem_raw, x, Dequant<T, Q>{uq, us},
                        Dequant<T, Q>{xcq, xcs}, Dequant<T, Q>{vq, vs}, y, M,
                        C, N, R1, R2, S);
}

template <typename T, typename Q, int BM>
int launch_branched_q(const void* x, const void* uq, const void* us,
                      const void* xcq, const void* xcs, const void* vq,
                      const void* vs, void* y, int M, int C, int N, int R1,
                      int R2, int S, cudaStream_t stream) {
  return launch_chain(
      branched_q_kernel<T, Q, BM>, branched_smem<T, BM>(N, R1, R2), M, S, BM,
      stream, static_cast<const T*>(x), static_cast<const Q*>(uq),
      static_cast<const float*>(us), static_cast<const Q*>(xcq),
      static_cast<const float*>(xcs), static_cast<const Q*>(vq),
      static_cast<const float*>(vs), static_cast<T*>(y), M, C, N, R1, R2, S);
}

template <typename T, typename Q>
int dispatch_bm(const void* x, const void* uq, const void* us,
                const void* xcq, const void* xcs, const void* vq,
                const void* vs, void* y, int M, int C, int N, int R1, int R2,
                int S, cudaStream_t s) {
  return pick_bm(M) == 8
             ? launch_branched_q<T, Q, 8>(x, uq, us, xcq, xcs, vq, vs, y, M,
                                          C, N, R1, R2, S, s)
             : launch_branched_q<T, Q, 32>(x, uq, us, xcq, xcs, vq, vs, y, M,
                                           C, N, R1, R2, S, s);
}

}  // namespace lrk

extern "C" {

// y (M,S) = sum_n ((x @ dq(uq[n])) @ dq(xcq[n])) @ dq(vq[n]); uq (N,C,R1),
// xcq (N,R1,R2), vq (N,R2,S) with scales us (N,1,R1), xcs (N,1,R2),
// vs (N,1,S), all row-major contiguous.  dtype: 0 = float32, 1 = bfloat16;
// qtype: 0 = int8, 1 = float8_e4m3fn.  Returns the launch's cudaError_t.
int lrk_branched_matmul_q(int dtype, int qtype, const void* x,
                          const void* uq, const void* us, const void* xcq,
                          const void* xcs, const void* vq, const void* vs,
                          void* y, int M, int C, int N, int R1, int R2, int S,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  using fp8 = __nv_fp8_e4m3;
  if (dtype == 0 && qtype == 0)
    return lrk::dispatch_bm<float, int8_t>(x, uq, us, xcq, xcs, vq, vs, y, M,
                                           C, N, R1, R2, S, s);
  if (dtype == 0 && qtype == 1)
    return lrk::dispatch_bm<float, fp8>(x, uq, us, xcq, xcs, vq, vs, y, M, C,
                                        N, R1, R2, S, s);
  if (dtype == 1 && qtype == 0)
    return lrk::dispatch_bm<bf16, int8_t>(x, uq, us, xcq, xcs, vq, vs, y, M,
                                          C, N, R1, R2, S, s);
  if (dtype == 1 && qtype == 1)
    return lrk::dispatch_bm<bf16, fp8>(x, uq, us, xcq, xcs, vq, vs, y, M, C,
                                       N, R1, R2, S, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
