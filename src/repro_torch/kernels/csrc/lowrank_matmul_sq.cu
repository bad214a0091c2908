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
// bf16 activations: lowrank_mma_kernel (branched_mma.cuh), one cooperative
// launch of the persistent grid of the split-phase core of bf16
// branched_matmul (branched_matmul.cu's note has the design) in two
// phases per row block of up to 64 rows, both factors read through
// mma_chain.cuh's Sparse24B view (a lowrank pack (2, K/4, N) is the
// one-branch case of branched_matmul_sq's u / v packs):
//   phase 1: h = round_bf16(x_blk @ ds(w0)), K = C, width R;
//   phase 2: y_blk = round_bf16(h @ ds(w1)), K = R, width S.
// The cluster chain below ran a whole launch on one 8-CTA cluster at the
// served k/v shape (8 SMs of 132 streaming, CUDA-core FMAs on groups
// expanded per thread); here each phase slices its reduction axis over
// the whole card (kernels/branched_matmul.py::lowrank_split), every
// item stages its pack's kept values, index words and scales by cp.async
// and expands each landed stage to bf16 -- exactly 0 at a pruned row, so
// a NaN activation meeting one still reaches y, as in the reference's
// dense dot -- one stage ahead of its mma.sync products.  A K-sliced
// phase stores f32 partials and, after a grid sync, sums them in slice
// order, so a second call gives the same bits.  At the served shape the
// weights are 160 KB: the launch is bound by its fixed costs (the
// cooperative launch, four grid syncs, each item's one-stage latency),
// not by bytes; the phase timer (%globaltimer) says how they split.  So
// it launches one CTA per SM of the two the persistent grid holds
// (lowrank_split's ctas): the phases have at most 64 items there, and a
// grid sync of 132 CTAs costs less than one of 264 (PERF.md).
//
// f32 activations: the chain of lowrank_matmul_q.cu (lrk_common.cuh
// lowrank_chain: an 8-CTA cluster shares each row block's h through
// distributed shared memory; TF32 tensor cores cannot hold f32's
// tolerance) with both weights read through the Sparse24 view: a staging
// thread expands a whole group of 4 rows of its column from the group's
// two kept values and two indices -- row 4g+t is the value of the slot
// whose index is t, times the column's scale, rounded to x's type T
// where expand_tile casts, or exactly 0 for a pruned row -- so it issues
// one load per staged value, where a row-by-row expand issued up to
// three and took 2.0-2.5x longer on an H100 (PERF.md).  Every row still
// takes its FMA, as the reference's dense dot does, so the FMA count is
// the dense chain's and shared memory is lowrank_matmul's at the same
// rank (lrk_lowrank_smem).  Its bf16 instantiation stays callable as a
// yardstick (chip_smoke's prev_ms); the wrapper never launches it for
// bf16.
#include "branched_mma.cuh"
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
  if constexpr (std::is_same<T, float>::value) {
    if (bm == 4)  // f32 only: lrk_common.cuh known_bm
      return launch_lowrank_sq<T, Q, 4>(x, w0sp, w0idx, w0s, w1sp, w1idx, w1s,
                                        y, M, C, R, S, s);
  }
  return bm == 8 ? launch_lowrank_sq<T, Q, 8>(x, w0sp, w0idx, w0s, w1sp,
                                              w1idx, w1s, y, M, C, R, S, s)
                 : launch_lowrank_sq<T, Q, 32>(x, w0sp, w0idx, w0s, w1sp,
                                               w1idx, w1s, y, M, C, R, S, s);
}

template <typename Q>
int launch_sq_mma(const void* x, const void* w0sp, const void* w0idx,
                  const void* w0s, const void* w1sp, const void* w1idx,
                  const void* w1s, void* y, void* p, void* h, int M, int C,
                  int R, int S, int k1, int k2, int ctas, void* ts,
                  cudaStream_t stream) {
  using P = mmac::Sparse24B<Q>;
  const auto f = [](const void* s) { return static_cast<const float*>(s); };
  const auto i8 = [](const void* s) { return static_cast<const int8_t*>(s); };
  const auto q = [](const void* s) { return static_cast<const Q*>(s); };
  return mmac::launch_lowrank(
      x, P{q(w0sp), i8(w0idx), f(w0s), R, mmac::row_div(C)},
      P{q(w1sp), i8(w1idx), f(w1s), S, mmac::row_div(R)}, y, p, h, M, C, R,
      S, k1, k2, ctas, ts, stream);
}

template <typename Q>
int lowrank_sq_grid(int rows) {
  using P = mmac::Sparse24B<Q>;
  return mmac::split_grid<P, P>(rows);
}

}  // namespace lrk

extern "C" {

// y (M,S) = (x (M,C) @ ds(w0)) @ ds(w1); w0: w0sp (2,C/4,R) int8 or e4m3,
// w0idx (2,C/4) int8 in {0..3}, w0s (1,R) f32; w1: w1sp (2,R/4,S),
// w1idx (2,R/4), w1s (1,S); all row-major contiguous.  dtype: 0 =
// float32, 1 = bfloat16 (x, y); qtype: 0 = int8, 1 = float8_e4m3fn; bm:
// the row block height, 8 or 32 (f32 also 4).  C and R must be multiples of 4.
// Returns the launch's cudaError_t (0 on success).
int lrk_lowrank_matmul_sq(int dtype, int qtype, int bm, const void* x,
                          const void* w0sp, const void* w0idx,
                          const void* w0s, const void* w1sp,
                          const void* w1idx, const void* w1s, void* y, int M,
                          int C, int R, int S, void* stream) {
  if (!lrk::known_bm(bm, dtype) || C % 4 != 0 || R % 4 != 0)
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

// Dynamic shared memory of the bf16 two-phase split kernel on 2:4 packs
// (bytes): fixed by its tile, whatever the ranks.
size_t lrk_lowrank_sq_mma_smem(void) {
  using P = mmac::Sparse24B<int8_t>;  // e4m3 stages the same bytes
  return mmac::split_smem<P, P>();
}

// Its persistent grid (CTAs) on the current device for a row block of
// `rows` rows (qtype: 0 = int8, 1 = e4m3), or minus the cudaError_t.
int lrk_lowrank_sq_mma_grid(int qtype, int rows) {
  if (qtype == 0) return lrk::lowrank_sq_grid<int8_t>(rows);
  if (qtype == 1) return lrk::lowrank_sq_grid<__nv_fp8_e4m3>(rows);
  return -(int)cudaErrorInvalidValue;
}

// bf16 y (M,S) = (x (M,C) @ ds(w0)) @ ds(w1) in one cooperative launch of
// the two-phase split kernel: operands as lrk_lowrank_matmul_sq's, x and y
// bf16; p / h the scratch regions lowrank_split lays out, k1 / k2 its
// K-slice lengths, ctas the CTAs it launches at most (0: the whole
// persistent grid); ts null, or 1 + 2 * ceil(M / 64) u64 slots for the
// phase timer.  C and R must be multiples of 4.  Returns the launch's
// cudaError_t.
int lrk_lowrank_matmul_sq_mma(int qtype, const void* x, const void* w0sp,
                              const void* w0idx, const void* w0s,
                              const void* w1sp, const void* w1idx,
                              const void* w1s, void* y, void* p, void* h,
                              int M, int C, int R, int S, int k1, int k2,
                              int ctas, void* ts, void* stream) {
  if (C % 4 != 0 || R % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qtype == 0)
    return lrk::launch_sq_mma<int8_t>(x, w0sp, w0idx, w0s, w1sp, w1idx, w1s,
                                      y, p, h, M, C, R, S, k1, k2, ctas, ts,
                                      s);
  if (qtype == 1)
    return lrk::launch_sq_mma<__nv_fp8_e4m3>(x, w0sp, w0idx, w0s, w1sp,
                                             w1idx, w1s, y, p, h, M, C, R,
                                             S, k1, k2, ctas, ts, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
