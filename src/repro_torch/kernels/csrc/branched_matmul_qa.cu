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
// (N*(C*r1 + r1*r2 + r2*S) int8 plus the scale rows, 2.2-8 MB a launch
// at llama's ranks, 0.7-2.4 us) and the activation rows; the int8
// operations are far below the tensor cores' rate.  What is left is fixed
// cost: a launch, the grid syncs, and the latency of each item's first
// stage.
//
// Design (qa_mma.cuh): one cooperative launch of a persistent grid
// (mmac::CoopLaunch, two CTAs a SM), its work split planned by qa_split in
// kernels/branched_matmul_qa.py.  x is quantized once for all M rows
// (phase 0), then per row block of up to 64 rows three product phases,
// each spread over the card in items (K slice, branch, 128-column tile)
// on mma.sync s8 tensor cores with exact int32 partials, each followed by
// a grid sync and a pass that sums the partials: after phases 1 and 2 one
// CTA per (row, branch) folds and requantizes the branch's segment
// (h1q / h2q, int8 scratch in device memory), after phase 3 every output
// element folds each branch's sum and adds them in branch order.  Phase
// 3's K slices lie inside one branch (each branch's sum is folded with its
// own h2 row scale).  One grid sync after phase 0, five per row block
// and one between row blocks.  Bit-equal to the plain version.
//
// The earlier design, kept callable as lrk_branched_matmul_qa (the
// wrapper's cluster_branched_matmul_qa, chip_smoke's prev_ms; the serve
// path never launches it): qa_common.cuh's cluster chain, one 8-CTA
// cluster per 32-row block with __dp4a products.  Stage 1 splits the N*r1
// columns of every branch's h1 across the 8 CTAs of the cluster (x
// quantized while staged, after a whole-row absmax pass), the cluster
// gathers h1 in f32, and each CTA requantizes every (row, branch) over
// that branch's r1 columns.  Stage 2 does the same for h2 over r2, reusing
// h1's f32 buffer once every CTA has gathered from it.  Stage 3 writes
// this CTA's output tiles, folding each branch's int32 sum before adding
// it to one f32 accumulator in branch order, as the reference does.
#include "qa_mma.cuh"

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

namespace qmma {

// x (M, C) T; uq (N, C, R1), xcq (N, R1, R2), vq (N, R2, S) int8 with f32
// scales us (N, 1, R1), xcs (N, 1, R2), vs (N, 1, S); y (M, S) T.
// Scratch (qa_split's regions): p, the int32 partials of the largest
// phase; xq (M, kpad(C)) and xs (M); h1q (rows, N * kpad(R1)), h1s (rows,
// N); h2q (rows, N * kpad(R2)), h2s (rows, N); rows = min(M, BM), reused
// by every row block.  k1 / k2 / k3: the K-slice lengths of the phases
// (multiples of BK; k3 slices each branch's R2).  ts: null, or
// 2 + 6 * row blocks slots CTA 0 fills with the time at the start, after
// phase 0 and, in every row block, after each product phase's items and
// after the pass that sums its partials (each up to the grid sync that
// ends it; with the timer on the last one syncs too).
template <typename T, int MT>
__global__ void __launch_bounds__(THREADS, 2)
branched_qa_mma_kernel(const T* __restrict__ x, const int8_t* uq,
                       const float* us, const int8_t* xcq, const float* xcs,
                       const int8_t* vq, const float* vs,
                       T* __restrict__ y, int* p, int8_t* xq, float* xs,
                       int8_t* h1q, float* h1s, int8_t* h2q, float* h2s,
                       int M, int C, int N, int R1, int R2, int S, int k1,
                       int k2, int k3, unsigned long long* ts) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int CP = kpad(C), L1 = N * kpad(R1), L2 = N * kpad(R2);
  const bool mark = ts != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  if (mark) *ts++ = global_ns();
  // phase 0: every row of x, quantized once
  float* red = reinterpret_cast<float*>(smem);  // between the phases' tiles
  quantize_rows<T>(x, xq, xs, M, C, red);
  grid.sync();
  if (mark) *ts++ = global_ns();
  for (int row0 = 0; row0 < M; row0 += BM) {
    const int rows = min(BM, M - row0);
    // phase 1: h1 of every branch, requantized per (row, branch)
    int_phase<MT>(xq + (size_t)row0 * CP, CP, 0, uq, (size_t)C * R1, C, R1,
                  N, k1, p, rows, smem);
    grid.sync();
    if (mark) *ts++ = global_ns();
    requant(p, cdiv(C, k1), N, rows, R1, xs + row0, 1, 0, us, h1q, L1, h1s,
            red);
    grid.sync();
    if (mark) *ts++ = global_ns();
    // phase 2: h2 of every branch from h1q
    int_phase<MT>(h1q, L1, kpad(R1), xcq, (size_t)R1 * R2, R1, R2, N, k2, p,
                  rows, smem);
    grid.sync();
    if (mark) *ts++ = global_ns();
    requant(p, cdiv(R1, k2), N, rows, R2, h1s, N, 1, xcs, h2q, L2, h2s,
            red);
    grid.sync();
    if (mark) *ts++ = global_ns();
    // phase 3: y rows = sum over branches of fold(h2q_n @ v_q[n])
    int_phase<MT>(h2q, L2, kpad(R2), vq, (size_t)R2 * S, R2, S, N, k3, p,
                  rows, smem);
    grid.sync();
    if (mark) *ts++ = global_ns();
    fold_y<T>(p, cdiv(R2, k3), N, rows, S, h2s, vs, y + (size_t)row0 * S,
              true);
    // p is read above and written by the next row block's phase 1
    if (row0 + BM < M || ts != nullptr) grid.sync();
    if (mark) *ts++ = global_ns();
  }
}

// The kernel as a CoopLaunch kernel, per activation type.
template <typename T>
struct QaKernels {
  static constexpr size_t SMEM = qmma::SMEM;
  template <int MT>
  static const void* fn() {
    return (const void*)branched_qa_mma_kernel<T, MT>;
  }
};

template <typename T>
int launch(const void* x, const void* uq, const void* us, const void* xcq,
           const void* xcs, const void* vq, const void* vs, void* y,
           void* p, void* xq, void* xs, void* h1q, void* h1s, void* h2q,
           void* h2s, int M, int C, int N, int R1, int R2, int S, int k1,
           int k2, int k3, void* ts, cudaStream_t stream) {
  if (M <= 0 || C <= 0 || N <= 0 || R1 <= 0 || R2 <= 0 || S <= 0 ||
      k1 <= 0 || k2 <= 0 || k3 <= 0 || k1 % BK || k2 % BK || k3 % BK)
    return (int)cudaErrorInvalidValue;
  return mmac::CoopLaunch<QaKernels<T>>::launch(
      M, 0, stream, static_cast<const T*>(x), static_cast<const int8_t*>(uq),
      static_cast<const float*>(us), static_cast<const int8_t*>(xcq),
      static_cast<const float*>(xcs), static_cast<const int8_t*>(vq),
      static_cast<const float*>(vs), static_cast<T*>(y),
      static_cast<int*>(p), static_cast<int8_t*>(xq),
      static_cast<float*>(xs), static_cast<int8_t*>(h1q),
      static_cast<float*>(h1s), static_cast<int8_t*>(h2q),
      static_cast<float*>(h2s), M, C, N, R1, R2, S, k1, k2, k3,
      static_cast<unsigned long long*>(ts));
}

}  // namespace qmma

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
  // the activation-quantized cluster kernels come at 8 and 32 rows only
  if (bm != 8 && bm != 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return qa::dispatch_bm<float>(bm, x, uq, us, xcq, xcs, vq, vs, y, M, C,
                                  N, R1, R2, S, s);
  if (dtype == 1)
    return qa::dispatch_bm<__nv_bfloat16>(bm, x, uq, us, xcq, xcs, vq, vs, y,
                                          M, C, N, R1, R2, S, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the split-phase s8 kernel (bytes): fixed by
// its tile, whatever the ranks.
size_t lrk_branched_qa_mma_smem(void) { return qmma::SMEM; }

// The persistent grid (CTAs) the split-phase s8 kernel launches with on
// the current device for a row block of `rows` rows, x in dtype (0 =
// float32, 1 = bfloat16), or minus the cudaError_t.
int lrk_branched_qa_mma_grid(int dtype, int rows) {
  using mmac::CoopLaunch;
  if (dtype == 0) return CoopLaunch<qmma::QaKernels<float>>::grid(rows);
  return CoopLaunch<qmma::QaKernels<__nv_bfloat16>>::grid(rows);
}

// y (M,S) = the activation-quantized branched chain (as
// lrk_branched_matmul_qa) in one cooperative launch of the split-phase
// s8 kernel; p / xq / xs / h1q / h1s / h2q / h2s are the scratch regions
// qa_split lays out, k1 / k2 / k3 its K-slice lengths (multiples of 64);
// ts null, or 2 + 6 * ceil(M / 64) u64 slots for the phase timer.  dtype:
// 0 = float32, 1 = bfloat16 (x, y).  Returns the launch's cudaError_t.
int lrk_branched_matmul_qa_mma(int dtype, const void* x, const void* uq,
                               const void* us, const void* xcq,
                               const void* xcs, const void* vq,
                               const void* vs, void* y, void* p, void* xq,
                               void* xs, void* h1q, void* h1s, void* h2q,
                               void* h2s, int M, int C, int N, int R1,
                               int R2, int S, int k1, int k2, int k3,
                               void* ts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return qmma::launch<float>(x, uq, us, xcq, xcs, vq, vs, y, p, xq, xs,
                               h1q, h1s, h2q, h2s, M, C, N, R1, R2, S, k1,
                               k2, k3, ts, s);
  if (dtype == 1)
    return qmma::launch<__nv_bfloat16>(x, uq, us, xcq, xcs, vq, vs, y, p, xq,
                                       xs, h1q, h1s, h2q, h2s, M, C, N, R1,
                                       R2, S, k1, k2, k3, ts, s);
  return (int)cudaErrorInvalidValue;
}


}  // extern "C"
