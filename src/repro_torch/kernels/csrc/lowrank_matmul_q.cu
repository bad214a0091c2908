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
// (lrk_lowrank_smem).  Plain f32 FMAs, exact in f32: f32 activations
// run this design, because TF32 tensor cores cannot hold f32's tolerance.
//
// bf16 activations: lowrank_mma_kernel (branched_mma.cuh), the two-phase
// split kernel of lowrank_matmul.cu with both factors read through
// mma_chain.cuh's DequantB view: each item stages its tile's int8 / e4m3
// bytes and its columns' scales by cp.async and converts each landed
// stage to round_bf16(q * scale) -- the TPU kernel's rounding -- one stage
// ahead of its mma.sync products.  Every served row is whole 128-byte
// lines (R = 128, 512, 768 and S = 512, 2048, 8192 bytes), so both views
// stage the tile's own bytes, not the line-fetching view branched_matmul_q
// gives u.  One cooperative launch whose two phases slice their reduction
// axis over the whole card (kernels/branched_matmul.py::lowrank_split),
// where the cluster design streamed a k/v launch's 256 KB of w0 through
// the 8 SMs of one cluster; f32 partials are summed in slice order, so a
// second call gives the same bits.  The cluster kernel's bf16
// instantiation stays callable as a yardstick (chip_smoke's prev_ms); the
// wrapper never launches it for bf16.
#include "branched_mma.cuh"
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
int dispatch_bm(int bm, const void* x, const void* w0q, const void* w0s,
                const void* w1q, const void* w1s, void* y, int M, int C,
                int R, int S, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    if (bm == 4)  // f32 only: lrk_common.cuh known_bm
      return launch_lowrank_q<T, Q, 4>(x, w0q, w0s, w1q, w1s, y, M, C, R, S,
                                       s);
  }
  return bm == 8
             ? launch_lowrank_q<T, Q, 8>(x, w0q, w0s, w1q, w1s, y, M, C, R,
                                         S, s)
             : launch_lowrank_q<T, Q, 32>(x, w0q, w0s, w1q, w1s, y, M, C, R,
                                          S, s);
}

template <typename Q>
int launch_lowrank_q_mma(const void* x, const void* w0q, const void* w0s,
                         const void* w1q, const void* w1s, void* y, void* p,
                         void* h, int M, int C, int R, int S, int k1, int k2,
                         int ctas, void* ts, cudaStream_t stream) {
  using V = mmac::DequantB<Q>;
  const auto f = [](const void* s) { return static_cast<const float*>(s); };
  const auto q = [](const void* s) { return static_cast<const Q*>(s); };
  return mmac::launch_lowrank(x, V{q(w0q), f(w0s), R, mmac::row_div(C)},
                              V{q(w1q), f(w1s), S, mmac::row_div(R)}, y, p,
                              h, M, C, R, S, k1, k2, ctas, ts, stream);
}

template <typename Q>
int lowrank_q_grid(int rows) {
  using V = mmac::DequantB<Q>;
  return mmac::split_grid<V, V>(rows);
}

}  // namespace lrk

extern "C" {

// y (M,S) = (x (M,C) @ dq(w0q (C,R), w0s (1,R))) @ dq(w1q (R,S), w1s (1,S)),
// all row-major contiguous.  dtype: 0 = float32, 1 = bfloat16 (x, y);
// qtype: 0 = int8, 1 = float8_e4m3fn (w0q, w1q); scales f32; bm: the
// row block height, 8 or 32 (f32 also 4).
// Returns the launch's cudaError_t (0 on success).
int lrk_lowrank_matmul_q(int dtype, int qtype, int bm, const void* x,
                         const void* w0q, const void* w0s, const void* w1q,
                         const void* w1s, void* y, int M, int C, int R, int S,
                         void* stream) {
  if (!lrk::known_bm(bm, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  using fp8 = __nv_fp8_e4m3;
  if (dtype == 0 && qtype == 0)
    return lrk::dispatch_bm<float, int8_t>(bm, x, w0q, w0s, w1q, w1s, y, M,
                                           C, R, S, s);
  if (dtype == 0 && qtype == 1)
    return lrk::dispatch_bm<float, fp8>(bm, x, w0q, w0s, w1q, w1s, y, M, C,
                                        R, S, s);
  if (dtype == 1 && qtype == 0)
    return lrk::dispatch_bm<bf16, int8_t>(bm, x, w0q, w0s, w1q, w1s, y, M,
                                          C, R, S, s);
  if (dtype == 1 && qtype == 1)
    return lrk::dispatch_bm<bf16, fp8>(bm, x, w0q, w0s, w1q, w1s, y, M, C,
                                       R, S, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the bf16 two-phase split kernel on quantized
// factors (bytes): fixed by its tile, whatever the ranks.
size_t lrk_lowrank_q_mma_smem(void) {
  using V = mmac::DequantB<int8_t>;  // e4m3 stages the same bytes
  return mmac::split_smem<V, V>();
}

// Its persistent grid (CTAs) on the current device for a row block of
// `rows` rows (qtype: 0 = int8, 1 = e4m3), or minus the cudaError_t.
int lrk_lowrank_q_mma_grid(int qtype, int rows) {
  if (qtype == 0) return lrk::lowrank_q_grid<int8_t>(rows);
  if (qtype == 1) return lrk::lowrank_q_grid<__nv_fp8_e4m3>(rows);
  return -(int)cudaErrorInvalidValue;
}

// bf16 y (M,S) = (x (M,C) @ dq(w0q, w0s)) @ dq(w1q, w1s) in one cooperative
// launch of the two-phase split kernel: operands as lrk_lowrank_matmul_q's,
// x and y bf16; p / h the scratch regions lowrank_split lays out, k1 / k2
// its K-slice lengths, ctas the CTAs it launches at most (0: the whole
// persistent grid); ts null, or 1 + 2 * ceil(M / 64) u64 slots for the
// phase timer.  Returns the launch's cudaError_t.
int lrk_lowrank_matmul_q_mma(int qtype, const void* x, const void* w0q,
                             const void* w0s, const void* w1q,
                             const void* w1s, void* y, void* p, void* h,
                             int M, int C, int R, int S, int k1, int k2,
                             int ctas, void* ts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qtype == 0)
    return lrk::launch_lowrank_q_mma<int8_t>(x, w0q, w0s, w1q, w1s, y, p, h,
                                             M, C, R, S, k1, k2, ctas, ts, s);
  if (qtype == 1)
    return lrk::launch_lowrank_q_mma<__nv_fp8_e4m3>(
        x, w0q, w0s, w1q, w1s, y, p, h, M, C, R, S, k1, k2, ctas, ts, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
