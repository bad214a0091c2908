// Activation-quantized low-rank matmul for Hopper (sm_90a): int8 x int8.
//   xq, xs = quantize_rows(x)                 (per-row absmax over C)
//   h      = (xq @ w0_q) * xs * w0_scale      (exact int32 sum, f32 fold)
//   hq, hs = quantize_rows(h)                 (per-row absmax over R)
//   y      = ((hq @ w1_q) * hs * w1_scale) -> x's type
//
// Replaces the TPU kernel src/repro/kernels/lowrank_matmul_qa.py
// (lowrank_matmul_qa, pl.pallas_call at :101; quantize_rows at :44).
// There the grid (M/bm, S/bn) computes h once per row block at j == 0 and
// keeps hq and its row scales in VMEM scratch for the later S tiles.
//
// What bounds it on an H100: at prefill row counts (M = 64 to 512) the
// weight bytes (C*R + R*S int8, plus the f32 scale rows) and the
// activation rows; the int8 operations (2*M*(C*R + R*S)) sit far below
// the 1,979 TOP/s of the tensor cores.
//
// Design (qa_common.cuh): an 8-CTA cluster shares each row block.  Every
// CTA first takes the row block's absmax over all of C (x is read twice:
// it cannot be held as int8 in shared memory at C = 8192), then computes
// its 1/8 of h's columns with __dp4a on x quantized while it is staged,
// folds (acc * xs) * w0_scale, and the cluster gathers h in f32.  Each
// CTA then requantizes the whole row itself -- the same rows, the same
// reduction, so the same hq and hs everywhere -- and writes its share of
// the output tiles from hq.  Simple first: plain dp4a, no tensor cores
// (mma.sync / wgmma s8 is later work).
#include "qa_common.cuh"

namespace qa {

template <int BM>
size_t lowrank_qa_smem(int R) {
  Layout l;
  l.take((size_t)BM * APAD);     // As
  l.take((size_t)NT * APAD);     // Bs
  l.take((size_t)BM * 4);        // x row scales
  l.take((size_t)BM * 4);        // h row scales
  l.take((size_t)BM * R * 4);    // h, f32
  l.take((size_t)BM * R);        // hq, int8
  return l.off;
}

template <typename T, int BM>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
lowrank_qa_kernel(const T* __restrict__ x, const int8_t* __restrict__ w0q,
                  const float* __restrict__ w0s,
                  const int8_t* __restrict__ w1q,
                  const float* __restrict__ w1s, T* __restrict__ y, int M,
                  int C, int R, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  Layout l;
  int8_t* As = reinterpret_cast<int8_t*>(smem + l.take((size_t)BM * APAD));
  int8_t* Bs = reinterpret_cast<int8_t*>(smem + l.take((size_t)NT * APAD));
  float* xs = reinterpret_cast<float*>(smem + l.take((size_t)BM * 4));
  float* hs = reinterpret_cast<float*>(smem + l.take((size_t)BM * 4));
  float* h = reinterpret_cast<float*>(smem + l.take((size_t)BM * R * 4));
  int8_t* hq = reinterpret_cast<int8_t*>(smem + l.take((size_t)BM * R));

  lrk::cg::cluster_group cluster = lrk::cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = blockIdx.y * BM;
  const int a_rows = min(BM, M - row0);
  const T* xb = x + (size_t)row0 * C;

  row_scales<T, BM>(xs, xb, C, a_rows, C);
  __syncthreads();

  const int W = (R + CLUSTER - 1) / CLUSTER;
  const int j0 = min(R, rank * W), j1 = min(R, j0 + W);
  const XRows<T> xrows{xb, C, xs};
  islice<BM>(h, R, j0, j1, R, [&](int) { return xrows; }, a_rows, w0q, 0,
             w0s, C, As, Bs);
  cluster.sync();
  lrk::gather_slices<float, BM>(cluster, h, R, W);
  cluster.sync();  // h complete here, and no CTA leaves while read remotely

  requant<BM>(h, R, R, 1, hq, hs);
  __syncthreads();
  const HRows hrows{hq, R, hs, 1};
  ioutput<T, BM>(y, row0, a_rows, S, [&](int) { return hrows; }, 1, R, w1q,
                 w1s, As, Bs);
}

template <typename T, int BM>
int launch(const void* x, const void* w0q, const void* w0s, const void* w1q,
           const void* w1s, void* y, int M, int C, int R, int S,
           cudaStream_t stream) {
  return lrk::launch_chain(
      lowrank_qa_kernel<T, BM>, lowrank_qa_smem<BM>(R), M, S, BM, stream,
      static_cast<const T*>(x), static_cast<const int8_t*>(w0q),
      static_cast<const float*>(w0s), static_cast<const int8_t*>(w1q),
      static_cast<const float*>(w1s), static_cast<T*>(y), M, C, R, S);
}

template <typename T>
int dispatch_bm(int bm, const void* x, const void* w0q, const void* w0s,
                const void* w1q, const void* w1s, void* y, int M, int C,
                int R, int S, cudaStream_t s) {
  return bm == 8
             ? launch<T, 8>(x, w0q, w0s, w1q, w1s, y, M, C, R, S, s)
             : launch<T, 32>(x, w0q, w0s, w1q, w1s, y, M, C, R, S, s);
}

}  // namespace qa

extern "C" {

// Dynamic shared memory of one launch at a row block of bm rows (8 or
// 32) and rank R.
size_t lrk_lowrank_qa_smem(int bm, int R) {
  return bm == 8 ? qa::lowrank_qa_smem<8>(R) : qa::lowrank_qa_smem<32>(R);
}

// y (M,S) = the activation-quantized chain of x (M,C) through w0q (C,R)
// int8 + w0s (1,R) f32 and w1q (R,S) int8 + w1s (1,S) f32, all row-major
// contiguous.  dtype: 0 = float32, 1 = bfloat16 (x, y); bm: the row block
// height, 8 or 32.  Returns the launch's cudaError_t (0 on success).
int lrk_lowrank_matmul_qa(int dtype, int bm, const void* x, const void* w0q,
                          const void* w0s, const void* w1q, const void* w1s,
                          void* y, int M, int C, int R, int S, void* stream) {
  if (!lrk::known_bm(bm)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return qa::dispatch_bm<float>(bm, x, w0q, w0s, w1q, w1s, y, M, C, R, S,
                                  s);
  if (dtype == 1)
    return qa::dispatch_bm<__nv_bfloat16>(bm, x, w0q, w0s, w1q, w1s, y, M, C,
                                          R, S, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
