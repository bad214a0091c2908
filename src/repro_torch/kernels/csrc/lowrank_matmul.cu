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
// through shared memory -- simple and exact in f32; tensor cores (wgmma)
// and TMA are later work.
#include "lrk_common.cuh"

namespace lrk {

template <typename T, int BM>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
lowrank_kernel(const T* __restrict__ x, const T* __restrict__ w0,
               const T* __restrict__ w1, T* __restrict__ y, int M, int C,
               int R, int S) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);
  float* Bs = As + BM * Depth<BM>::KC;
  T* h = reinterpret_cast<T*>(Bs + Depth<BM>::KC * NT);  // (BM, R)

  const int row0 = blockIdx.y * BM;
  const int a_rows = min(BM, M - row0);

  // Stage 1: this CTA's slice of h = x_blk @ w0, rounded to T.
  const int W = (R + CLUSTER - 1) / CLUSTER;
  const int j0 = min(R, rank * W), j1 = min(R, j0 + W);
  slice_product<T, BM>(h, R, j0, j1, R, x + (size_t)row0 * C, C, 0, a_rows,
                       w0, 0, C, As, Bs);
  cluster.sync();
  gather_slices<T, BM>(cluster, h, R, W);
  cluster.sync();  // h complete here, and no CTA leaves while read remotely

  // Stage 2: y tiles = h @ w1.
  output_tiles<T, BM>(y, row0, a_rows, S, h, R, R, 1, w1, As, Bs);
}

template <typename T, int BM>
size_t lowrank_smem(int R) {
  return staging_bytes<T, BM>() + (size_t)BM * R * sizeof(T);
}

template <typename T, int BM>
int launch_lowrank(const void* x, const void* w0, const void* w1, void* y,
                   int M, int C, int R, int S, cudaStream_t stream) {
  const size_t smem = lowrank_smem<T, BM>(R);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      lowrank_kernel<T, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  lowrank_kernel<T, BM><<<chain_grid(M, S, BM), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w0),
      static_cast<const T*>(w1), static_cast<T*>(y), M, C, R, S);
  return (int)cudaGetLastError();
}

}  // namespace lrk

// Row block height: 8 rows for decode-sized M, else 32.
static int pick_bm(int M) { return M <= 8 ? 8 : 32; }

extern "C" {

// Shared memory one launch needs (bytes); the wrapper refuses a rank
// whose intermediate does not fit.  dtype: 0 = float32, 1 = bfloat16.
size_t lrk_lowrank_smem(int dtype, int M, int R) {
  const int bm = pick_bm(M);
  if (dtype == 0)
    return bm == 8 ? lrk::lowrank_smem<float, 8>(R)
                   : lrk::lowrank_smem<float, 32>(R);
  return bm == 8 ? lrk::lowrank_smem<__nv_bfloat16, 8>(R)
                 : lrk::lowrank_smem<__nv_bfloat16, 32>(R);
}

// y (M,S) = (x (M,C) @ w0 (C,R)) @ w1 (R,S), all row-major contiguous.
// Returns the launch's cudaError_t (0 on success).
int lrk_lowrank_matmul(int dtype, const void* x, const void* w0,
                       const void* w1, void* y, int M, int C, int R, int S,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bm = pick_bm(M);
  using bf16 = __nv_bfloat16;
  if (dtype == 0)
    return bm == 8
               ? lrk::launch_lowrank<float, 8>(x, w0, w1, y, M, C, R, S, s)
               : lrk::launch_lowrank<float, 32>(x, w0, w1, y, M, C, R, S, s);
  if (dtype == 1)
    return bm == 8
               ? lrk::launch_lowrank<bf16, 8>(x, w0, w1, y, M, C, R, S, s)
               : lrk::launch_lowrank<bf16, 32>(x, w0, w1, y, M, C, R, S, s);
  return (int)cudaErrorInvalidValue;
}

const char* lrk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
