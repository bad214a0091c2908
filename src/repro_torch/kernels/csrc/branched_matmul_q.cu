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
// bf16 activations: the split-phase tensor-core kernel of bf16
// branched_matmul (branched_mma.cuh; branched_matmul.cu's note has the
// design: one cooperative launch of a persistent grid, three K-sliced
// phases over every SM, each weight byte read once per 64-row block) with
// every factor read through mma_chain.cuh's DequantB view.  Its ring
// stages carry the raw int8 / e4m3 bytes (half of bf16's) and the
// scales of the stage's branch by cp.async; once a stage has landed, each
// thread converts 16 values to round_bf16(f32(q) * scale) -- where the
// TPU kernel casts (branched_matmul_q.py:47-49) -- into one of two bf16
// tiles, while the warps multiply the other on mma.sync.  Phase 3 reads
// v as one (N*r2, S) stack, so a row k takes branch k / r2's scale row
// (a stage's first row's, staged; a later row of another branch, only at
// a rank that is not a multiple of 32, reads its own from device
// memory).  The roundings are the TPU
// kernel's: h1 and h2 to bf16 once after their full f32 sum, y one f32
// sum over every branch.
//
// f32 activations: the chain of branched_matmul.cu (lrk_common.cuh
// branched_chain: h1 and h2 of every branch in shared memory, shared by
// an 8-CTA cluster, the branch sum in one f32 accumulator per output
// tile) with every weight read through the Dequant view: q * scale
// rounded to x's type, widened to f32 for the FMA (TF32 tensor cores
// cannot reach f32's tolerance).  The scale view moves by r1, r2 or S
// columns per branch with its factor.  Shared memory as branched_matmul
// at the same ranks (lrk_branched_smem).  Its bf16 instantiation stays
// callable as a yardstick (chip_smoke's prev_ms); the wrapper never
// launches it for bf16.
#include "branched_mma.cuh"
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
int dispatch_bm(int bm, const void* x, const void* uq, const void* us,
                const void* xcq, const void* xcs, const void* vq,
                const void* vs, void* y, int M, int C, int N, int R1, int R2,
                int S, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    if (bm == 4)  // f32 only: lrk_common.cuh known_bm
      return launch_branched_q<T, Q, 4>(x, uq, us, xcq, xcs, vq, vs, y, M, C,
                                        N, R1, R2, S, s);
  }
  return bm == 8
             ? launch_branched_q<T, Q, 8>(x, uq, us, xcq, xcs, vq, vs, y, M,
                                          C, N, R1, R2, S, s)
             : launch_branched_q<T, Q, 32>(x, uq, us, xcq, xcs, vq, vs, y, M,
                                           C, N, R1, R2, S, s);
}

// u's view fetches whole lines where its rows are not line-aligned
// (mma_chain.cuh DequantB); xc's and v's stage the tile's own bytes.
template <typename Q>
using UView = mmac::DequantB<Q, true>;
template <typename Q>
using QView = mmac::DequantB<Q>;

template <typename Q>
int launch_q_mma(const void* x, const void* uq, const void* us,
                 const void* xcq, const void* xcs, const void* vq,
                 const void* vs, void* y, void* p, void* h1, void* h2, int M,
                 int C, int N, int R1, int R2, int S, int k1, int k2, int k3,
                 void* ts, cudaStream_t stream) {
  using V = QView<Q>;
  const auto f = [](const void* s) { return static_cast<const float*>(s); };
  return mmac::launch_split(
      x, UView<Q>{static_cast<const Q*>(uq), f(us), R1, mmac::row_div(C)},
      V{static_cast<const Q*>(xcq), f(xcs), R2, mmac::row_div(R1)},
      V{static_cast<const Q*>(vq), f(vs), S, mmac::row_div(R2)}, y, p, h1,
      h2, M, C, N, R1, R2, S, k1, k2, k3, ts, stream);
}

}  // namespace lrk

extern "C" {

// y (M,S) = sum_n ((x @ dq(uq[n])) @ dq(xcq[n])) @ dq(vq[n]); uq (N,C,R1),
// xcq (N,R1,R2), vq (N,R2,S) with scales us (N,1,R1), xcs (N,1,R2),
// vs (N,1,S), all row-major contiguous.  dtype: 0 = float32, 1 = bfloat16;
// qtype: 0 = int8, 1 = float8_e4m3fn; bm: the row block height, 8 or
// 32 (f32 also 4).  Returns the launch's cudaError_t.
int lrk_branched_matmul_q(int dtype, int qtype, int bm, const void* x,
                          const void* uq, const void* us, const void* xcq,
                          const void* xcs, const void* vq, const void* vs,
                          void* y, int M, int C, int N, int R1, int R2, int S,
                          void* stream) {
  if (!lrk::known_bm(bm, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  using fp8 = __nv_fp8_e4m3;
  if (dtype == 0 && qtype == 0)
    return lrk::dispatch_bm<float, int8_t>(bm, x, uq, us, xcq, xcs, vq, vs,
                                           y, M, C, N, R1, R2, S, s);
  if (dtype == 0 && qtype == 1)
    return lrk::dispatch_bm<float, fp8>(bm, x, uq, us, xcq, xcs, vq, vs, y,
                                        M, C, N, R1, R2, S, s);
  if (dtype == 1 && qtype == 0)
    return lrk::dispatch_bm<bf16, int8_t>(bm, x, uq, us, xcq, xcs, vq, vs,
                                          y, M, C, N, R1, R2, S, s);
  if (dtype == 1 && qtype == 1)
    return lrk::dispatch_bm<bf16, fp8>(bm, x, uq, us, xcq, xcs, vq, vs, y,
                                       M, C, N, R1, R2, S, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the bf16 split-phase kernel on quantized
// factors (bytes): fixed by its tile, whatever the ranks.
size_t lrk_branched_q_mma_smem(void) {
  using V = lrk::QView<int8_t>;  // e4m3 stages the same bytes
  return mmac::split_smem<lrk::UView<int8_t>, V, V>();
}

// Its persistent grid (CTAs) on the current device for a row block of
// `rows` rows (qtype: 0 = int8, 1 = e4m3), or minus the cudaError_t.
int lrk_branched_q_mma_grid(int qtype, int rows) {
  if (qtype == 0) {
    using V = lrk::QView<int8_t>;
    return mmac::split_grid<lrk::UView<int8_t>, V, V>(rows);
  }
  if (qtype == 1) {
    using Q = __nv_fp8_e4m3;
    using V = lrk::QView<Q>;
    return mmac::split_grid<lrk::UView<Q>, V, V>(rows);
  }
  return -(int)cudaErrorInvalidValue;
}

// bf16 y (M,S) = sum_n ((x @ dq(uq[n])) @ dq(xcq[n])) @ dq(vq[n]) in one
// cooperative launch of the split-phase kernel: operands as
// lrk_branched_matmul_q's, x and y bf16; p / h1 / h2 the scratch regions
// branched_split lays out, k1 / k2 / k3 its K-slice lengths; ts null, or
// 1 + 3 * ceil(M / 64) u64 slots for the phase timer.  Returns the
// launch's cudaError_t.
int lrk_branched_matmul_q_mma(int qtype, const void* x, const void* uq,
                              const void* us, const void* xcq,
                              const void* xcs, const void* vq,
                              const void* vs, void* y, void* p, void* h1,
                              void* h2, int M, int C, int N, int R1, int R2,
                              int S, int k1, int k2, int k3, void* ts,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qtype == 0)
    return lrk::launch_q_mma<int8_t>(x, uq, us, xcq, xcs, vq, vs, y, p, h1,
                                     h2, M, C, N, R1, R2, S, k1, k2, k3, ts,
                                     s);
  if (qtype == 1)
    return lrk::launch_q_mma<__nv_fp8_e4m3>(x, uq, us, xcq, xcs, vq, vs, y,
                                            p, h1, h2, M, C, N, R1, R2, S,
                                            k1, k2, k3, ts, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
