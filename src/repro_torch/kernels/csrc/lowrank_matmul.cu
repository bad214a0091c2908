// Fused low-rank matmul y = (x @ w0) @ w1 for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/lowrank_matmul.py
// (lowrank_matmul, pl.pallas_call at :68).  There the grid runs in order:
// h_i = x_i @ w0 is computed once per row block at j == 0 into VMEM
// scratch and reused by every later S step.  Blocks on a GPU run in no
// order, so nothing carries over between them.
//
// What bounds it on an H100: at decode (M = slots = 8) the work is a few
// FLOPs per weight byte, far below the ~295 FLOP/byte the card needs to be
// compute bound -- the weight bytes (C*R + R*S) bound it.  At prefill
// chunks (M = 64) it is still below that line for every rank the slice
// uses.
//
// Design: the grid is (CLUSTER * groups, row blocks).  The CLUSTER CTAs of
// a thread block cluster share one row block: each computes a 1/CLUSTER
// slice of h's columns, rounds it to x's type exactly where the TPU kernel
// casts (lowrank_matmul.py:46), and the cluster gathers the slices through
// distributed shared memory, so w0 is read once per cluster rather than
// once per CTA and h never touches device memory.  Each CTA then walks its
// share of the S tiles with h resident in shared memory.  More clusters
// per row block (groups) spread the w1 stream over more SMs at the cost of
// recomputing h once per cluster.  Products are plain f32 FMAs staged
// through shared memory, exact in f32.  f32 activations ran this design
// until the f32 form (chain_f32.cu: output-tiled, K-sliced split-TF32
// launches over the whole card) replaced it; its f32 and bf16
// instantiations stay callable as yardsticks (chip_smoke's prev_ms).
//
// bf16 activations: lowrank_mma_kernel (branched_mma.cuh), the two-phase
// split kernel of lowrank_matmul_sq.cu with both factors read through
// mma_chain.cuh's PlainB view (bf16 tiles staged by cp.async straight
// into the ring, no conversion):
//   phase 1: h = round_bf16(x_blk @ w0), K = C, width R;
//   phase 2: y_blk = round_bf16(h @ w1), K = R, width S,
// one cooperative launch whose phases slice their reduction axis over the
// whole card (kernels/branched_matmul.py::lowrank_split) where the
// cluster design above streamed a k/v launch's 512 KB of w0 through the
// 8 SMs of one cluster.  h rounds to bf16 where the TPU kernel casts;
// f32 partials are summed in slice order, so a second call gives the same
// bits.  The cluster kernel's bf16 instantiation stays callable as a
// yardstick (chip_smoke's prev_ms); the wrapper never launches it.
// bf16 calls of M >= LARGE_M rows take the large-M form
// (chain_wgmma.cuh: two output-tiled wgmma launches, h then y).
#include "branched_mma.cuh"
#include "lrk_common.cuh"

namespace lrk {

template <typename T, int BM>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
lowrank_kernel(const T* __restrict__ x, const T* __restrict__ w0,
               const T* __restrict__ w1, T* __restrict__ y, int M, int C,
               int R, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  lowrank_chain<T, BM>(smem_raw, x, Plain<T>{w0}, Plain<T>{w1}, y, M, C, R,
                       S);
}

template <typename T, int BM>
int launch_lowrank(const void* x, const void* w0, const void* w1, void* y,
                   int M, int C, int R, int S, cudaStream_t stream) {
  return launch_chain(lowrank_kernel<T, BM>, lowrank_smem<T, BM>(R), M, S,
                      BM, stream, static_cast<const T*>(x),
                      static_cast<const T*>(w0), static_cast<const T*>(w1),
                      static_cast<T*>(y), M, C, R, S);
}

}  // namespace lrk

extern "C" {

// Shared memory one launch needs (bytes) at a row block of bm rows (4, 8
// or 32); the wrappers pick bm from it and refuse a rank whose
// intermediate fits at none.  dtype: 0 = float32, 1 = bfloat16.
// The quantized kernel (lowrank_matmul_q.cu) stages its weights in f32
// like this one, so it needs the same.
size_t lrk_lowrank_smem(int dtype, int bm, int R) {
  if (dtype == 0)
    return bm == 4   ? lrk::lowrank_smem<float, 4>(R)
           : bm == 8 ? lrk::lowrank_smem<float, 8>(R)
                     : lrk::lowrank_smem<float, 32>(R);
  return bm == 4   ? lrk::lowrank_smem<__nv_bfloat16, 4>(R)
         : bm == 8 ? lrk::lowrank_smem<__nv_bfloat16, 8>(R)
                   : lrk::lowrank_smem<__nv_bfloat16, 32>(R);
}

// y (M,S) = (x (M,C) @ w0 (C,R)) @ w1 (R,S), all row-major contiguous,
// in row blocks of bm rows (8 or 32; f32 also 4).  Returns the launch's
// cudaError_t (0 on success).
int lrk_lowrank_matmul(int dtype, int bm, const void* x, const void* w0,
                       const void* w1, void* y, int M, int C, int R, int S,
                       void* stream) {
  if (!lrk::known_bm(bm, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype == 0)
    return bm == 4
               ? lrk::launch_lowrank<float, 4>(x, w0, w1, y, M, C, R, S, s)
           : bm == 8
               ? lrk::launch_lowrank<float, 8>(x, w0, w1, y, M, C, R, S, s)
               : lrk::launch_lowrank<float, 32>(x, w0, w1, y, M, C, R, S, s);
  if (dtype == 1)
    return bm == 8
               ? lrk::launch_lowrank<bf16, 8>(x, w0, w1, y, M, C, R, S, s)
               : lrk::launch_lowrank<bf16, 32>(x, w0, w1, y, M, C, R, S, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the bf16 two-phase split kernel on bf16
// factors (bytes): fixed by its tile, whatever the ranks.
size_t lrk_lowrank_mma_smem(void) {
  using V = mmac::PlainB;
  return mmac::split_smem<V, V>();
}

// Its persistent grid (CTAs) on the current device for a row block of
// `rows` rows, or minus the cudaError_t.
int lrk_lowrank_mma_grid(int rows) {
  using V = mmac::PlainB;
  return mmac::split_grid<V, V>(rows);
}

// bf16 y (M,S) = (x (M,C) @ w0 (C,R)) @ w1 (R,S) in one cooperative launch
// of the two-phase split kernel, all bf16 row-major contiguous; p / h the
// scratch regions lowrank_split lays out, k1 / k2 its K-slice lengths,
// ctas the CTAs it launches at most (0: the whole persistent grid); ts
// null, or 1 + 2 * ceil(M / 64) u64 slots for the phase timer.  Returns
// the launch's cudaError_t (0 on success).
int lrk_lowrank_matmul_mma(const void* x, const void* w0, const void* w1,
                           void* y, void* p, void* h, int M, int C, int R,
                           int S, int k1, int k2, int ctas, void* ts,
                           void* stream) {
  using bf16 = __nv_bfloat16;
  using V = mmac::PlainB;
  return mmac::launch_lowrank(x, V{static_cast<const bf16*>(w0), R, C},
                              V{static_cast<const bf16*>(w1), S, R}, y, p, h,
                              M, C, R, S, k1, k2, ctas, ts,
                              static_cast<cudaStream_t>(stream));
}

const char* lrk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
