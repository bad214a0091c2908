// The C entry of the large-M form of B1 / B2 and of B3 / B4
// (chain_wgmma.cuh, whose note says what it replaces, what bounds it and
// how it is built): every product of one call of a chain, in the order its
// plan (kernels/branched_matmul.py::large_m_plan) lists them, from one host
// call (kernels/branched_matmul.py::launch_large_m).
#include "chain_wgmma.cuh"

extern "C" {

// One call of the large-M form: the n products of its plan, launched in
// order on `stream`.  Product i is the SPEC longs at spec + i * SPEC:
//   a, a_ld, a_group, a_groups, b, b_ld, b_group, b_groups, c, ldc,
//   c_group, M, N, K, out_groups, sum_groups, bm, bn, stages, scale, ks,
//   p, p_ld
// with a, b, c, scale, p slots of `ptrs` (the call's x, factors, y, scales
// and scratch regions; scale and p -1 where unused), and computes
//   c[z*c_group + m*ldc + n] = round_bf16( sum_{s < sum_groups}
//       sum_{k < K} A_g[m, k] * B_g[k, n] ),  g = z + s,
// z < out_groups, m < M, n < N, with A_g[m, k] = a[m*a_ld + g'*a_group +
// k] (g' = g where a_groups > 1, else 0), bf16, one of out_groups and
// sum_groups 1.  scale -1: B_g[k, n] = b[g*b_group + k*b_ld + n], bf16,
// the K loop whole (ks at least its ceil(K / 64) * sum_groups iterations).
// Else b holds int8 (qcode 0) or e4m3 (1) bytes at those offsets and
// B_g[k, n] = round_bf16(f32(b[...]) * scale[g*N + n]), the K loop's
// iterations are cut into slices of ks, whose f32 partials go to p (rows
// of p_ld floats) and are summed in slice order by the last CTA of each
// tile, found on `tickets` (n_tickets zeroed int32, left zeroed).  Every
// stride a multiple of 16 bytes and a, b 16-byte aligned (TMA); bm x bn
// the output tile, 64 or 128 each (quantized: bn 128 with bm 256 or 128,
// bn 64 with bm 128 or 64);
// stages the ring's depth, 2-6.
// Returns the first failing launch's cudaError_t (0 on success).
int lrk_chain_wgmma(int n, const long long* spec, const void* const* ptrs,
                    int qcode, void* tickets, int n_tickets, void* stream) {
  constexpr int SPEC = 23;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < n; ++i) {
    const long long* q = spec + (size_t)i * SPEC;
    const void* a = ptrs[q[0]];
    const void* b = ptrs[q[4]];
    void* c = const_cast<void*>(ptrs[q[8]]);
    const int M = (int)q[11], N = (int)q[12], K = (int)q[13];
    const int out_groups = (int)q[14], sum_groups = (int)q[15];
    const int bm = (int)q[16], bn = (int)q[17], stages = (int)q[18];
    const float* scale =
        q[19] < 0 ? nullptr : static_cast<const float*>(ptrs[q[19]]);
    const long long iters = (long long)((K + wgc::BK - 1) / wgc::BK) *
                            sum_groups;
    const int ks = (int)q[20];
    float* p = q[21] < 0 ? nullptr
                         : static_cast<float*>(const_cast<void*>(ptrs[q[21]]));
    const long long p_ld = q[22];
    if (M <= 0 || N <= 0 || K <= 0 || out_groups <= 0 || sum_groups <= 0 ||
        (out_groups > 1 && sum_groups > 1) ||
        (scale == nullptr && ks < iters) ||
        (scale != nullptr && (qcode < 0 || qcode > 1)))
      return (int)cudaErrorInvalidValue;
    int rc = (int)cudaErrorInvalidValue;
#define LRK_CHAIN_WGMMA(BN, WG)                                              \
    if (scale == nullptr && bn == BN && bm == 64 * WG)                      \
      rc = wgc::launch_gemm<BN, WG>(a, q[1], q[2], (int)q[3], b, q[5], q[6],\
                                    (int)q[7], c, q[9], q[10], M, N, K,     \
                                    out_groups, sum_groups, stages, st);
    LRK_CHAIN_WGMMA(128, 2)
    LRK_CHAIN_WGMMA(64, 2)
    LRK_CHAIN_WGMMA(128, 1)
    LRK_CHAIN_WGMMA(64, 1)
#undef LRK_CHAIN_WGMMA
#define LRK_CHAIN_Q(WG, BM, Q)                                               \
    rc = wgc::launch_gemm_q<WG, BM, Q>(                                     \
        a, q[1], q[2], (int)q[3], b, q[5], q[6], (int)q[7], scale, c, q[9], \
        q[10], p, p_ld, static_cast<int*>(tickets), n_tickets, M, N, K,     \
        out_groups, sum_groups, ks, stages, st);
#define LRK_CHAIN_WGMMA_Q(WG, BM)                                            \
    if (scale != nullptr && bn == 64 * WG && bm == BM) {                    \
      if (qcode == 0) {                                                     \
        LRK_CHAIN_Q(WG, BM, int8_t)                                         \
      } else {                                                              \
        LRK_CHAIN_Q(WG, BM, __nv_fp8_e4m3)                                  \
      }                                                                     \
    }
    LRK_CHAIN_WGMMA_Q(2, 256)
    LRK_CHAIN_WGMMA_Q(2, 128)
    LRK_CHAIN_WGMMA_Q(1, 128)
    LRK_CHAIN_WGMMA_Q(1, 64)
#undef LRK_CHAIN_WGMMA_Q
#undef LRK_CHAIN_Q
    if (rc != 0) return rc;
  }
  return 0;
}

}  // extern "C"
