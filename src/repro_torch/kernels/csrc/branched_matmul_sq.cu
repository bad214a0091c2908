// Branched low-rank matmul on 2:4-packed quantized factors for Hopper
// (sm_90a):
//   y = sum_n ((x @ ds(u_n)) @ dq(xc_n)) @ ds(v_n)     (paper Eq. 17)
//
// Replaces the TPU kernel src/repro/kernels/branched_matmul_sq.py
// (branched_matmul_sq, pl.pallas_call at :94): the outer factors u and v
// arrive per branch as 2:4-packed int8 or e4m3 kept values (u_sp
// (N,2,C/4,r1), v_sp (N,2,r2/4,S)), int8 within-group row positions and
// f32 per-output-channel scales, and are expanded and dequantized on
// chip (expand_tile, lowrank_matmul_sq.py:45); the core xc stays a dense
// quantized tile (N,r1,r2) with scales (N,1,r2).  The intermediates and
// the branch sum never touch device memory.
//
// What bounds it on an H100: the weight bytes (N*(C*r1/2 + r1*r2 +
// r2*S/2) values, N*(C/2 + r2/2) index bytes, the scale rows) -- a few
// FLOPs per byte at decode and at prefill-chunk row counts.
//
// bf16 activations: the split-phase tensor-core kernel of bf16
// branched_matmul (branched_mma.cuh; branched_matmul.cu's note has the
// design) with u and v read through mma_chain.cuh's Sparse24B view and
// xc through DequantB.  A ring stage of a pack carries, by cp.async, the
// two slots' kept values of its 8 groups of 4 rows (a quarter of bf16's
// bytes), the 4-byte words around their 16 index bytes and the scales of
// its branch; once it has landed, each warp expands one group into 4
// rows of round_bf16(value * scale), exactly 0 where pruned (so a NaN
// activation meeting a pruned row still reaches y, as in the reference's
// dense dot), into one of two bf16 tiles, while the warps multiply the
// other on mma.sync.  A 2:4 group never straddles a stage or a branch: C
// and r2 are multiples of 4 and a stage is 32 rows.
//
// f32 activations: the chain of branched_matmul_q.cu (lrk_common.cuh
// branched_chain: h1 and h2 of every branch in shared memory, shared by
// an 8-CTA cluster, the branch sum in one f32 accumulator per output
// tile) with u and v read through the Sparse24 view -- a staging thread
// expands a group of 4 rows of its column from two kept values and two
// indices, each row the value of its slot times the column's scale,
// rounded to x's type, or exactly 0 where pruned -- and xc through the
// Dequant view.  Per branch a pack moves by K*N/2 values, K/2 indices
// and N scales.  Every row takes its FMA as in the dense chain; shared
// memory is branched_matmul's at the same ranks (lrk_branched_smem).
// Its bf16 instantiation stays callable as a yardstick (chip_smoke's
// prev_ms); the wrapper never launches it for bf16.
#include "branched_mma.cuh"
#include "lrk_common.cuh"

namespace lrk {

template <typename T, typename Q, int BM>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
branched_sq_kernel(const T* __restrict__ x, const Q* __restrict__ usp,
                   const int8_t* __restrict__ uidx,
                   const float* __restrict__ us, const Q* __restrict__ xcq,
                   const float* __restrict__ xcs, const Q* __restrict__ vsp,
                   const int8_t* __restrict__ vidx,
                   const float* __restrict__ vs, T* __restrict__ y, int M,
                   int C, int N, int R1, int R2, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  branched_chain<T, BM>(smem_raw, x, Sparse24<T, Q>{usp, uidx, us},
                        Dequant<T, Q>{xcq, xcs},
                        Sparse24<T, Q>{vsp, vidx, vs}, y, M, C, N, R1, R2,
                        S);
}

template <typename T, typename Q, int BM>
int launch_branched_sq(const void* x, const void* usp, const void* uidx,
                       const void* us, const void* xcq, const void* xcs,
                       const void* vsp, const void* vidx, const void* vs,
                       void* y, int M, int C, int N, int R1, int R2, int S,
                       cudaStream_t stream) {
  return launch_chain(
      branched_sq_kernel<T, Q, BM>, branched_smem<T, BM>(N, R1, R2), M, S,
      BM, stream, static_cast<const T*>(x), static_cast<const Q*>(usp),
      static_cast<const int8_t*>(uidx), static_cast<const float*>(us),
      static_cast<const Q*>(xcq), static_cast<const float*>(xcs),
      static_cast<const Q*>(vsp), static_cast<const int8_t*>(vidx),
      static_cast<const float*>(vs), static_cast<T*>(y), M, C, N, R1, R2, S);
}

template <typename T, typename Q>
int dispatch_bm(int bm, const void* x, const void* usp, const void* uidx,
                const void* us, const void* xcq, const void* xcs,
                const void* vsp, const void* vidx, const void* vs, void* y,
                int M, int C, int N, int R1, int R2, int S, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    if (bm == 4)  // f32 only: lrk_common.cuh known_bm
      return launch_branched_sq<T, Q, 4>(x, usp, uidx, us, xcq, xcs, vsp, vidx,
                                         vs, y, M, C, N, R1, R2, S, s);
  }
  return bm == 8
             ? launch_branched_sq<T, Q, 8>(x, usp, uidx, us, xcq, xcs, vsp,
                                           vidx, vs, y, M, C, N, R1, R2, S,
                                           s)
             : launch_branched_sq<T, Q, 32>(x, usp, uidx, us, xcq, xcs, vsp,
                                            vidx, vs, y, M, C, N, R1, R2, S,
                                            s);
}

template <typename Q>
int launch_sq_mma(const void* x, const void* usp, const void* uidx,
                  const void* us, const void* xcq, const void* xcs,
                  const void* vsp, const void* vidx, const void* vs, void* y,
                  void* p, void* h1, void* h2, int M, int C, int N, int R1,
                  int R2, int S, int k1, int k2, int k3, void* ts,
                  cudaStream_t stream) {
  using P = mmac::Sparse24B<Q>;
  using D = mmac::DequantB<Q>;
  const auto f = [](const void* s) { return static_cast<const float*>(s); };
  const auto i8 = [](const void* s) { return static_cast<const int8_t*>(s); };
  return mmac::launch_split(
      x,
      P{static_cast<const Q*>(usp), i8(uidx), f(us), R1, mmac::row_div(C)},
      D{static_cast<const Q*>(xcq), f(xcs), R2, mmac::row_div(R1)},
      P{static_cast<const Q*>(vsp), i8(vidx), f(vs), S, mmac::row_div(R2)},
      y, p, h1, h2, M, C, N, R1, R2, S, k1, k2, k3, ts, stream);
}

template <typename Q>
int sq_grid(int rows) {
  using P = mmac::Sparse24B<Q>;
  return mmac::split_grid<P, mmac::DequantB<Q>, P>(rows);
}

}  // namespace lrk

extern "C" {

// y (M,S) = sum_n ((x @ ds(u[n])) @ dq(xc[n])) @ ds(v[n]); usp
// (N,2,C/4,R1) + uidx (N,2,C/4) + us (N,1,R1); xcq (N,R1,R2) + xcs
// (N,1,R2); vsp (N,2,R2/4,S) + vidx (N,2,R2/4) + vs (N,1,S); all
// row-major contiguous.  dtype: 0 = float32, 1 = bfloat16; qtype: 0 =
// int8, 1 = float8_e4m3fn (usp, xcq, vsp); bm: the row block height, 8
// or 32 (f32 also 4).  C and R2 must be multiples of 4.  Returns the launch's
// cudaError_t.
int lrk_branched_matmul_sq(int dtype, int qtype, int bm, const void* x,
                           const void* usp, const void* uidx, const void* us,
                           const void* xcq, const void* xcs, const void* vsp,
                           const void* vidx, const void* vs, void* y, int M,
                           int C, int N, int R1, int R2, int S,
                           void* stream) {
  if (!lrk::known_bm(bm, dtype) || C % 4 != 0 || R2 % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  using fp8 = __nv_fp8_e4m3;
  if (dtype == 0 && qtype == 0)
    return lrk::dispatch_bm<float, int8_t>(bm, x, usp, uidx, us, xcq, xcs,
                                           vsp, vidx, vs, y, M, C, N, R1, R2,
                                           S, s);
  if (dtype == 0 && qtype == 1)
    return lrk::dispatch_bm<float, fp8>(bm, x, usp, uidx, us, xcq, xcs, vsp,
                                        vidx, vs, y, M, C, N, R1, R2, S, s);
  if (dtype == 1 && qtype == 0)
    return lrk::dispatch_bm<bf16, int8_t>(bm, x, usp, uidx, us, xcq, xcs,
                                          vsp, vidx, vs, y, M, C, N, R1, R2,
                                          S, s);
  if (dtype == 1 && qtype == 1)
    return lrk::dispatch_bm<bf16, fp8>(bm, x, usp, uidx, us, xcq, xcs, vsp,
                                       vidx, vs, y, M, C, N, R1, R2, S, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the bf16 split-phase kernel on 2:4 packs
// (bytes): fixed by its tile, whatever the ranks.
size_t lrk_branched_sq_mma_smem(void) {
  using P = mmac::Sparse24B<int8_t>;  // e4m3 stages the same bytes
  return mmac::split_smem<P, mmac::DequantB<int8_t>, P>();
}

// Its persistent grid (CTAs) on the current device for a row block of
// `rows` rows (qtype: 0 = int8, 1 = e4m3), or minus the cudaError_t.
int lrk_branched_sq_mma_grid(int qtype, int rows) {
  if (qtype == 0) return lrk::sq_grid<int8_t>(rows);
  if (qtype == 1) return lrk::sq_grid<__nv_fp8_e4m3>(rows);
  return -(int)cudaErrorInvalidValue;
}

// bf16 y (M,S) = sum_n ((x @ ds(u[n])) @ dq(xc[n])) @ ds(v[n]) in one
// cooperative launch of the split-phase kernel: operands as
// lrk_branched_matmul_sq's, x and y bf16; p / h1 / h2 the scratch regions
// branched_split lays out, k1 / k2 / k3 its K-slice lengths; ts null, or
// 1 + 3 * ceil(M / 64) u64 slots for the phase timer.  C and R2 must be
// multiples of 4.  Returns the launch's cudaError_t.
int lrk_branched_matmul_sq_mma(int qtype, const void* x, const void* usp,
                               const void* uidx, const void* us,
                               const void* xcq, const void* xcs,
                               const void* vsp, const void* vidx,
                               const void* vs, void* y, void* p, void* h1,
                               void* h2, int M, int C, int N, int R1,
                               int R2, int S, int k1, int k2, int k3,
                               void* ts, void* stream) {
  if (C % 4 != 0 || R2 % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qtype == 0)
    return lrk::launch_sq_mma<int8_t>(x, usp, uidx, us, xcq, xcs, vsp, vidx,
                                      vs, y, p, h1, h2, M, C, N, R1, R2, S,
                                      k1, k2, k3, ts, s);
  if (qtype == 1)
    return lrk::launch_sq_mma<__nv_fp8_e4m3>(x, usp, uidx, us, xcq, xcs,
                                             vsp, vidx, vs, y, p, h1, h2, M,
                                             C, N, R1, R2, S, k1, k2, k3, ts,
                                             s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
