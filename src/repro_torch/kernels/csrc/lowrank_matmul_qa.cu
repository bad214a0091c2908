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
// weight bytes (C*R + R*S int8, plus the f32 scale rows: 0.33 MB at
// llama's k/v pair, 0.2 us) and the activation rows; the int8 operations
// (2*M*(C*R + R*S)) sit far below the tensor cores' rate.  What is left is
// fixed cost: a launch, the grid syncs, the latency of each item's first
// stage.
//
// Design (qa_mma.cuh, B7's core in two product phases): one cooperative
// launch of a persistent grid (mmac::CoopLaunch; by default one CTA a SM
// where no phase has more items than SMs), its work split planned by
// lowrank_qa_split in kernels/lowrank_matmul_qa.py.  x is quantized once
// for all M rows (phase 0), then per row block of up to 64 rows:
//   phase 1: items (K slice of C, 128-column tile of R) of xq @ w0_q on
//     mma.sync s8 with exact int32 partials; after a grid sync one CTA
//     per row folds (acc * xs) * w0_scale and requantizes the row over R
//     into hq / hs (int8 scratch in device memory, kpos order);
//   phase 2: items (K slice of R, 128-column tile of S) of hq @ w1_q;
//     after a grid sync every output element folds
//     (acc * hs) * w1_scale and rounds it once to x's type.
// One grid sync after phase 0, four per row block (the last one only
// between row blocks).  Bit-equal to the plain version at every plan.
//
// The earlier design, kept callable as lrk_lowrank_matmul_qa (the
// wrapper's cluster_lowrank_matmul_qa, chip_smoke's prev_ms; the serve
// path never launches it), is qa_common.cuh's cluster chain: an 8-CTA
// cluster shares each row block.  Every CTA first takes the row block's
// absmax over all of C (x is read twice: it cannot be held as int8 in
// shared memory at C = 8192), then computes its 1/8 of h's columns with
// __dp4a on x quantized while it is staged, folds (acc * xs) * w0_scale,
// and the cluster gathers h in f32.  Each CTA then requantizes the whole
// row itself -- the same rows, the same reduction, so the same hq and hs
// everywhere -- and writes its share of the output tiles from hq.
#include "qa_mma.cuh"

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

namespace qmma {

// x (M, C) T; w0q (C, R), w1q (R, S) int8 with f32 scales w0s (1, R), w1s
// (1, S); y (M, S) T.  Scratch (lowrank_qa_split's regions): p, the int32
// partials of the larger phase; xq (M, kpad(C)) and xs
// (M); hq (rows, kpad(R)) and hs (rows), rows = min(M, BM), reused by
// every row block.  k1 / k2: the K-slice lengths of the phases (multiples
// of BK).  ts: null, or 2 + 4 * row blocks slots CTA 0 fills with the
// time at the start, after phase 0 and, in every row block, after phase
// 1's items, after the requantization, after phase 2's items and after
// the fold (each up to the grid sync that ends it; with the timer on the
// last one syncs too).
template <typename T, int MT>
__global__ void __launch_bounds__(THREADS, 2)
lowrank_qa_mma_kernel(const T* __restrict__ x, const int8_t* w0q,
                      const float* w0s, const int8_t* w1q, const float* w1s,
                      T* __restrict__ y, int* p, int8_t* xq, float* xs,
                      int8_t* hq, float* hs, int M, int C, int R, int S,
                      int k1, int k2, unsigned long long* ts) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int CP = kpad(C), RP = kpad(R);
  const bool mark = ts != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  float* red = reinterpret_cast<float*>(smem);  // between the phases' tiles
  if (mark) *ts++ = global_ns();
  // phase 0: every row of x, quantized once
  quantize_rows<T>(x, xq, xs, M, C, red);
  grid.sync();
  if (mark) *ts++ = global_ns();
  for (int row0 = 0; row0 < M; row0 += BM) {
    const int rows = min(BM, M - row0);
    // phase 1: h = (xq @ w0_q) * xs * w0_scale, requantized per row
    int_phase<MT>(xq + (size_t)row0 * CP, CP, 0, w0q, 0, C, R, 1, k1, p,
                  rows, smem);
    grid.sync();
    if (mark) *ts++ = global_ns();
    requant(p, cdiv(C, k1), 1, rows, R, xs + row0, 1, 0, w0s, hq, RP, hs,
            red);
    grid.sync();
    if (mark) *ts++ = global_ns();
    // phase 2: y rows = round_T((hq @ w1_q) * hs * w1_scale)
    int_phase<MT>(hq, RP, 0, w1q, 0, R, S, 1, k2, p, rows, smem);
    grid.sync();
    if (mark) *ts++ = global_ns();
    fold_y<T>(p, cdiv(R, k2), 1, rows, S, hs, w1s, y + (size_t)row0 * S,
              false);
    // p is read above and written by the next row block's phase 1
    if (row0 + BM < M || ts != nullptr) grid.sync();
    if (mark) *ts++ = global_ns();
  }
}

// The kernel as a CoopLaunch kernel, per activation type.
template <typename T>
struct LowrankQaKernels {
  static constexpr size_t SMEM = qmma::SMEM;
  template <int MT>
  static const void* fn() {
    return (const void*)lowrank_qa_mma_kernel<T, MT>;
  }
};

template <typename T>
int launch_lowrank(const void* x, const void* w0q, const void* w0s,
                   const void* w1q, const void* w1s, void* y, void* p,
                   void* xq, void* xs, void* hq, void* hs, int M, int C,
                   int R, int S, int k1, int k2, int ctas, void* ts,
                   cudaStream_t stream) {
  if (M <= 0 || C <= 0 || R <= 0 || S <= 0 || k1 <= 0 || k2 <= 0 ||
      k1 % BK || k2 % BK || ctas < 0)
    return (int)cudaErrorInvalidValue;
  return mmac::CoopLaunch<LowrankQaKernels<T>>::launch(
      M, ctas, stream, static_cast<const T*>(x),
      static_cast<const int8_t*>(w0q), static_cast<const float*>(w0s),
      static_cast<const int8_t*>(w1q), static_cast<const float*>(w1s),
      static_cast<T*>(y), static_cast<int*>(p), static_cast<int8_t*>(xq),
      static_cast<float*>(xs), static_cast<int8_t*>(hq),
      static_cast<float*>(hs), M, C, R, S, k1, k2,
      static_cast<unsigned long long*>(ts));
}

}  // namespace qmma

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
  // the activation-quantized cluster kernels come at 8 and 32 rows only
  if (bm != 8 && bm != 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return qa::dispatch_bm<float>(bm, x, w0q, w0s, w1q, w1s, y, M, C, R, S,
                                  s);
  if (dtype == 1)
    return qa::dispatch_bm<__nv_bfloat16>(bm, x, w0q, w0s, w1q, w1s, y, M, C,
                                          R, S, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the split-phase s8 lowrank kernel (bytes):
// fixed by its tile, whatever the rank.
size_t lrk_lowrank_qa_mma_smem(void) { return qmma::SMEM; }

// The persistent grid (CTAs) the split-phase s8 lowrank kernel launches
// with on the current device for a row block of `rows` rows, x in dtype
// (0 = float32, 1 = bfloat16), or minus the cudaError_t.
int lrk_lowrank_qa_mma_grid(int dtype, int rows) {
  using mmac::CoopLaunch;
  using qmma::LowrankQaKernels;
  if (dtype == 0) return CoopLaunch<LowrankQaKernels<float>>::grid(rows);
  return CoopLaunch<LowrankQaKernels<__nv_bfloat16>>::grid(rows);
}

// y (M,S) = the activation-quantized chain (as lrk_lowrank_matmul_qa) in
// one cooperative launch of the split-phase s8 kernel on at most `ctas`
// CTAs (0: the whole persistent grid); p / xq / xs / hq / hs are the
// scratch regions lowrank_qa_split lays out, k1 / k2 its K-slice lengths
// (multiples of 64); ts null, or 2 + 4 * ceil(M / 64) u64 slots for the
// phase timer.  dtype: 0 = float32, 1 = bfloat16 (x, y).  Returns the
// launch's cudaError_t.
int lrk_lowrank_matmul_qa_mma(int dtype, const void* x, const void* w0q,
                              const void* w0s, const void* w1q,
                              const void* w1s, void* y, void* p, void* xq,
                              void* xs, void* hq, void* hs, int M, int C,
                              int R, int S, int k1, int k2, int ctas,
                              void* ts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return qmma::launch_lowrank<float>(x, w0q, w0s, w1q, w1s, y, p, xq, xs,
                                       hq, hs, M, C, R, S, k1, k2, ctas, ts,
                                       s);
  if (dtype == 1)
    return qmma::launch_lowrank<__nv_bfloat16>(x, w0q, w0s, w1q, w1s, y, p,
                                               xq, xs, hq, hs, M, C, R, S,
                                               k1, k2, ctas, ts, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
