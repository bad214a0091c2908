// Activation-quantized branched low-rank matmul for Hopper (sm_90a):
//   xq, xs = quantize_rows(x)                          (once per row)
//   per branch n:
//     h1 = (xq @ u_q[n]) * xs * u_scale[n];     h1q, h1s = quantize_rows(h1)
//     h2 = (h1q @ xc_q[n]) * h1s * xc_scale[n]; h2q, h2s = quantize_rows(h2)
//     y += (h2q @ v_q[n]) * h2s * v_scale[n]           (f32, branch order)
//   y -> x's type.
//
// Replaces the TPU kernel src/repro/kernels/branched_matmul_qa.py
// (branched_matmul_qa, pl.pallas_call at :96).  There the grid
// (M/bm, S/bn, N) quantizes x into VMEM scratch at the first step of a
// row block and carries the f32 branch sum across the in-order branch
// axis.
//
// What bounds it on an H100: at prefill row counts the weight bytes
// (N*(C*r1 + r1*r2 + r2*S) int8 plus the scale rows) and the activation
// rows; the int8 operations are far below the tensor cores' rate.
//
// Design (qa_common.cuh): the cluster chain of branched_matmul.cu with
// int8 operands.  Stage 1 splits the N*r1 columns of every branch's h1
// across the 8 CTAs of the cluster (x quantized while staged, after a
// whole-row absmax pass), the cluster gathers h1 in f32, and each CTA
// requantizes every (row, branch) over that branch's r1 columns.  Stage 2
// does the same for h2 over r2, reusing h1's f32 buffer once every CTA
// has gathered from it.  Stage 3 writes this CTA's output tiles, folding
// each branch's int32 sum before adding it to one f32 accumulator in
// branch order, as the reference does.
#include "qa_common.cuh"

namespace qa {

template <int BM>
size_t branched_qa_smem(int N, int R1, int R2) {
  const int LA = N * R1, LB = N * R2;
  Layout l;
  l.take((size_t)BM * APAD);                         // As
  l.take((size_t)NT * APAD);                         // Bs
  l.take((size_t)BM * 4);                            // x row scales
  l.take((size_t)BM * N * 4);                        // h1 row scales
  l.take((size_t)BM * N * 4);                        // h2 row scales
  l.take((size_t)BM * (LA > LB ? LA : LB) * 4);      // h1, then h2, f32
  l.take((size_t)BM * LA);                           // h1q
  l.take((size_t)BM * LB);                           // h2q
  return l.off;
}

template <typename T, int BM>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
branched_qa_kernel(const T* __restrict__ x, const int8_t* __restrict__ uq,
                   const float* __restrict__ us,
                   const int8_t* __restrict__ xcq,
                   const float* __restrict__ xcs,
                   const int8_t* __restrict__ vq,
                   const float* __restrict__ vs, T* __restrict__ y, int M,
                   int C, int N, int R1, int R2, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int LA = N * R1, LB = N * R2;
  Layout l;
  int8_t* As = reinterpret_cast<int8_t*>(smem + l.take((size_t)BM * APAD));
  int8_t* Bs = reinterpret_cast<int8_t*>(smem + l.take((size_t)NT * APAD));
  float* xs = reinterpret_cast<float*>(smem + l.take((size_t)BM * 4));
  float* h1s = reinterpret_cast<float*>(smem + l.take((size_t)BM * N * 4));
  float* h2s = reinterpret_cast<float*>(smem + l.take((size_t)BM * N * 4));
  float* hf = reinterpret_cast<float*>(
      smem + l.take((size_t)BM * (LA > LB ? LA : LB) * 4));
  int8_t* h1q = reinterpret_cast<int8_t*>(smem + l.take((size_t)BM * LA));
  int8_t* h2q = reinterpret_cast<int8_t*>(smem + l.take((size_t)BM * LB));

  lrk::cg::cluster_group cluster = lrk::cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = blockIdx.y * BM;
  const int a_rows = min(BM, M - row0);
  const T* xb = x + (size_t)row0 * C;

  row_scales<T, BM>(xs, xb, C, a_rows, C);
  __syncthreads();

  // stage 1: h1 of every branch, requantized per (row, branch)
  const int W1 = (LA + CLUSTER - 1) / CLUSTER;
  const XRows<T> xrows{xb, C, xs};
  islice<BM>(hf, LA, min(LA, rank * W1), min(LA, rank * W1 + W1), R1,
             [&](int) { return xrows; }, a_rows, uq, (size_t)C * R1, us, C,
             As, Bs);
  cluster.sync();
  lrk::gather_slices<float, BM>(cluster, hf, LA, W1);
  cluster.sync();  // every CTA has gathered: hf may be overwritten below
  requant<BM>(hf, LA, R1, N, h1q, h1s);
  __syncthreads();

  // stage 2: h2 of every branch from h1q, into the same f32 buffer
  const int W2 = (LB + CLUSTER - 1) / CLUSTER;
  islice<BM>(hf, LB, min(LB, rank * W2), min(LB, rank * W2 + W2), R2,
             [&](int n) { return HRows{h1q + n * R1, LA, h1s + n, N}; }, BM,
             xcq, (size_t)R1 * R2, xcs, R1, As, Bs);
  cluster.sync();
  lrk::gather_slices<float, BM>(cluster, hf, LB, W2);
  cluster.sync();  // h2 complete, and no CTA leaves while read remotely
  requant<BM>(hf, LB, R2, N, h2q, h2s);
  __syncthreads();

  // stage 3: y tiles = sum_n fold(h2q_n @ v_q[n])
  ioutput<T, BM>(y, row0, a_rows, S,
                 [&](int n) { return HRows{h2q + n * R2, LB, h2s + n, N}; },
                 N, R2, vq, vs, As, Bs);
}

template <typename T, int BM>
int launch(const void* x, const void* uq, const void* us, const void* xcq,
           const void* xcs, const void* vq, const void* vs, void* y, int M,
           int C, int N, int R1, int R2, int S, cudaStream_t stream) {
  return lrk::launch_chain(
      branched_qa_kernel<T, BM>, branched_qa_smem<BM>(N, R1, R2), M, S, BM,
      stream, static_cast<const T*>(x), static_cast<const int8_t*>(uq),
      static_cast<const float*>(us), static_cast<const int8_t*>(xcq),
      static_cast<const float*>(xcs), static_cast<const int8_t*>(vq),
      static_cast<const float*>(vs), static_cast<T*>(y), M, C, N, R1, R2, S);
}

template <typename T>
int dispatch_bm(int bm, const void* x, const void* uq, const void* us,
                const void* xcq, const void* xcs, const void* vq,
                const void* vs, void* y, int M, int C, int N, int R1, int R2,
                int S, cudaStream_t s) {
  return bm == 8
             ? launch<T, 8>(x, uq, us, xcq, xcs, vq, vs, y, M, C, N, R1, R2,
                            S, s)
             : launch<T, 32>(x, uq, us, xcq, xcs, vq, vs, y, M, C, N, R1, R2,
                             S, s);
}

}  // namespace qa

extern "C" {

// Dynamic shared memory of one launch at a row block of bm rows (8 or
// 32), N branches of ranks (R1, R2).
size_t lrk_branched_qa_smem(int bm, int N, int R1, int R2) {
  return bm == 8 ? qa::branched_qa_smem<8>(N, R1, R2)
                 : qa::branched_qa_smem<32>(N, R1, R2);
}

// y (M,S) = the activation-quantized branched chain of x (M,C) through
// uq (N,C,R1), xcq (N,R1,R2), vq (N,R2,S) int8 with f32 scales us
// (N,1,R1), xcs (N,1,R2), vs (N,1,S), all row-major contiguous.  dtype:
// 0 = float32, 1 = bfloat16 (x, y); bm: the row block height, 8 or 32.
// Returns the launch's cudaError_t.
int lrk_branched_matmul_qa(int dtype, int bm, const void* x, const void* uq,
                           const void* us, const void* xcq, const void* xcs,
                           const void* vq, const void* vs, void* y, int M,
                           int C, int N, int R1, int R2, int S,
                           void* stream) {
  if (!lrk::known_bm(bm)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return qa::dispatch_bm<float>(bm, x, uq, us, xcq, xcs, vq, vs, y, M, C,
                                  N, R1, R2, S, s);
  if (dtype == 1)
    return qa::dispatch_bm<__nv_bfloat16>(bm, x, uq, us, xcq, xcs, vq, vs, y,
                                          M, C, N, R1, R2, S, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
