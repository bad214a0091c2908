// Fused low-rank matmul on 2:4-packed quantized factors for Hopper
// (sm_90a):
//   y = (x @ ds(w0)) @ ds(w1),  ds(w) = round_T(expand_2:4(w_sp) * scale)
//
// Replaces the TPU kernel src/repro/kernels/lowrank_matmul_sq.py
// (lowrank_matmul_sq, pl.pallas_call at :108, with expand_tile at :45):
// each factor arrives as slot-major kept values (2, K/4, N), int8 or
// e4m3, int8 within-group row positions (2, K/4, 1) and f32
// per-output-channel scales (1, N), and is expanded and dequantized on
// chip right before its product; neither a dense weight nor the rank
// intermediate h touches device memory.
//
// What bounds it on an H100: the weight bytes, now half a byte per
// logical value (C*R/2 + R*S/2 kept values, C/2 + R/2 index bytes, R + S
// f32 scales) -- still a few FLOPs per byte at decode (M = 8) and at
// prefill chunks (M = 64).
//
// Design: the chain of lowrank_matmul_q.cu (lrk_common.cuh lowrank_chain:
// an 8-CTA cluster shares each row block's h through distributed shared
// memory) with both weights read through the Sparse24 view: a staging
// thread expands a whole group of 4 rows of its column from the group's
// two kept values and two indices -- row 4g+t is the value of the slot
// whose index is t, times the column's scale, rounded to x's type T
// where expand_tile casts, or exactly 0 for a pruned row -- so it issues
// one load per staged value, where a row-by-row expand issued up to
// three and took 2.0-2.5x longer on an H100 (PERF.md).  Every row still
// takes its FMA, as the reference's dense dot does, so the FMA count is
// the dense chain's and shared memory is lowrank_matmul's at the same
// rank (lrk_lowrank_smem).  Skipping the pruned rows (and Hopper's
// sparse mma.sp) is later work.
#include "lrk_common.cuh"

namespace lrk {

template <typename T, typename Q, int BM>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
lowrank_sq_kernel(const T* __restrict__ x, const Q* __restrict__ w0sp,
                  const int8_t* __restrict__ w0idx,
                  const float* __restrict__ w0s, const Q* __restrict__ w1sp,
                  const int8_t* __restrict__ w1idx,
                  const float* __restrict__ w1s, T* __restrict__ y, int M,
                  int C, int R, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  lowrank_chain<T, BM>(smem_raw, x, Sparse24<T, Q>{w0sp, w0idx, w0s},
                       Sparse24<T, Q>{w1sp, w1idx, w1s}, y, M, C, R, S);
}

template <typename T, typename Q, int BM>
int launch_lowrank_sq(const void* x, const void* w0sp, const void* w0idx,
                      const void* w0s, const void* w1sp, const void* w1idx,
                      const void* w1s, void* y, int M, int C, int R, int S,
                      cudaStream_t stream) {
  return launch_chain(
      lowrank_sq_kernel<T, Q, BM>, lowrank_smem<T, BM>(R), M, S, BM, stream,
      static_cast<const T*>(x), static_cast<const Q*>(w0sp),
      static_cast<const int8_t*>(w0idx), static_cast<const float*>(w0s),
      static_cast<const Q*>(w1sp), static_cast<const int8_t*>(w1idx),
      static_cast<const float*>(w1s), static_cast<T*>(y), M, C, R, S);
}

template <typename T, typename Q>
int dispatch_bm(int bm, const void* x, const void* w0sp, const void* w0idx,
                const void* w0s, const void* w1sp, const void* w1idx,
                const void* w1s, void* y, int M, int C, int R, int S,
                cudaStream_t s) {
  return bm == 8 ? launch_lowrank_sq<T, Q, 8>(x, w0sp, w0idx, w0s, w1sp,
                                              w1idx, w1s, y, M, C, R, S, s)
                 : launch_lowrank_sq<T, Q, 32>(x, w0sp, w0idx, w0s, w1sp,
                                               w1idx, w1s, y, M, C, R, S, s);
}

}  // namespace lrk

extern "C" {

// y (M,S) = (x (M,C) @ ds(w0)) @ ds(w1); w0: w0sp (2,C/4,R) int8 or e4m3,
// w0idx (2,C/4) int8 in {0..3}, w0s (1,R) f32; w1: w1sp (2,R/4,S),
// w1idx (2,R/4), w1s (1,S); all row-major contiguous.  dtype: 0 =
// float32, 1 = bfloat16 (x, y); qtype: 0 = int8, 1 = float8_e4m3fn; bm:
// the row block height, 8 or 32.  C and R must be multiples of 4.
// Returns the launch's cudaError_t (0 on success).
int lrk_lowrank_matmul_sq(int dtype, int qtype, int bm, const void* x,
                          const void* w0sp, const void* w0idx,
                          const void* w0s, const void* w1sp,
                          const void* w1idx, const void* w1s, void* y, int M,
                          int C, int R, int S, void* stream) {
  if (!lrk::known_bm(bm) || C % 4 != 0 || R % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  using fp8 = __nv_fp8_e4m3;
  if (dtype == 0 && qtype == 0)
    return lrk::dispatch_bm<float, int8_t>(bm, x, w0sp, w0idx, w0s, w1sp,
                                           w1idx, w1s, y, M, C, R, S, s);
  if (dtype == 0 && qtype == 1)
    return lrk::dispatch_bm<float, fp8>(bm, x, w0sp, w0idx, w0s, w1sp,
                                        w1idx, w1s, y, M, C, R, S, s);
  if (dtype == 1 && qtype == 0)
    return lrk::dispatch_bm<bf16, int8_t>(bm, x, w0sp, w0idx, w0s, w1sp,
                                          w1idx, w1s, y, M, C, R, S, s);
  if (dtype == 1 && qtype == 1)
    return lrk::dispatch_bm<bf16, fp8>(bm, x, w0sp, w0idx, w0s, w1sp,
                                       w1idx, w1s, y, M, C, R, S, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
