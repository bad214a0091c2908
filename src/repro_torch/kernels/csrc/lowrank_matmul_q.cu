// Fused low-rank matmul on quantized factors for Hopper (sm_90a):
//   y = (x @ dq(w0)) @ dq(w1),  dq(w) = round_T(w_q * w_scale[col])
//
// Replaces the TPU kernel src/repro/kernels/lowrank_matmul_q.py
// (lowrank_matmul_q, pl.pallas_call at :75): int8 or e4m3 factor tiles
// with f32 per-output-channel scales (w0_scale (1,R), w1_scale (1,S)),
// dequantized on chip right before the product; neither a dequantized
// weight nor the rank intermediate h touches device memory.
//
// What bounds it on an H100: the weight bytes, now one byte per value
// (C*R + R*S, plus R + S f32 scales) -- still a few FLOPs per byte at
// decode (M = 8) and at prefill chunks (M = 64).
//
// Design: the chain of lowrank_matmul.cu (lrk_common.cuh lowrank_chain:
// an 8-CTA cluster shares each row block's h through distributed shared
// memory), with the weight operand read through the Dequant view: each
// staged value is q * scale rounded to x's type T -- where the TPU kernel
// casts (lowrank_matmul_q.py:42-48) -- then widened to f32 for the FMA.
// h rounds to T as in lowrank_matmul.  Staging stays f32, so a launch
// needs the shared memory of lowrank_matmul at the same rank
// (lrk_lowrank_smem).  Plain f32 FMAs; tensor cores are later work.
#include "lrk_common.cuh"

namespace lrk {

template <typename T, typename Q, int BM>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
lowrank_q_kernel(const T* __restrict__ x, const Q* __restrict__ w0q,
                 const float* __restrict__ w0s, const Q* __restrict__ w1q,
                 const float* __restrict__ w1s, T* __restrict__ y, int M,
                 int C, int R, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  lowrank_chain<T, BM>(smem_raw, x, Dequant<T, Q>{w0q, w0s},
                       Dequant<T, Q>{w1q, w1s}, y, M, C, R, S);
}

template <typename T, typename Q, int BM>
int launch_lowrank_q(const void* x, const void* w0q, const void* w0s,
                     const void* w1q, const void* w1s, void* y, int M, int C,
                     int R, int S, cudaStream_t stream) {
  return launch_chain(lowrank_q_kernel<T, Q, BM>, lowrank_smem<T, BM>(R), M,
                      S, BM, stream, static_cast<const T*>(x),
                      static_cast<const Q*>(w0q),
                      static_cast<const float*>(w0s),
                      static_cast<const Q*>(w1q),
                      static_cast<const float*>(w1s), static_cast<T*>(y), M,
                      C, R, S);
}

template <typename T, typename Q>
int dispatch_bm(const void* x, const void* w0q, const void* w0s,
                const void* w1q, const void* w1s, void* y, int M, int C,
                int R, int S, cudaStream_t s) {
  return pick_bm(M) == 8
             ? launch_lowrank_q<T, Q, 8>(x, w0q, w0s, w1q, w1s, y, M, C, R,
                                         S, s)
             : launch_lowrank_q<T, Q, 32>(x, w0q, w0s, w1q, w1s, y, M, C, R,
                                          S, s);
}

}  // namespace lrk

extern "C" {

// y (M,S) = (x (M,C) @ dq(w0q (C,R), w0s (1,R))) @ dq(w1q (R,S), w1s (1,S)),
// all row-major contiguous.  dtype: 0 = float32, 1 = bfloat16 (x, y);
// qtype: 0 = int8, 1 = float8_e4m3fn (w0q, w1q); scales f32.
// Returns the launch's cudaError_t (0 on success).
int lrk_lowrank_matmul_q(int dtype, int qtype, const void* x,
                         const void* w0q, const void* w0s, const void* w1q,
                         const void* w1s, void* y, int M, int C, int R, int S,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  using fp8 = __nv_fp8_e4m3;
  if (dtype == 0 && qtype == 0)
    return lrk::dispatch_bm<float, int8_t>(x, w0q, w0s, w1q, w1s, y, M, C, R,
                                           S, s);
  if (dtype == 0 && qtype == 1)
    return lrk::dispatch_bm<float, fp8>(x, w0q, w0s, w1q, w1s, y, M, C, R, S,
                                        s);
  if (dtype == 1 && qtype == 0)
    return lrk::dispatch_bm<bf16, int8_t>(x, w0q, w0s, w1q, w1s, y, M, C, R,
                                          S, s);
  if (dtype == 1 && qtype == 1)
    return lrk::dispatch_bm<bf16, fp8>(x, w0q, w0s, w1q, w1s, y, M, C, R, S,
                                       s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
