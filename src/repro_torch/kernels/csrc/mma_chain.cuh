// Tensor-core tile core of the split-phase chain kernels (sm_90a).
//
// One CTA of THREADS = 256 threads (8 warps) computes an f32 tile of up to
// BM = 64 activation rows by BN = 128 output columns over one slice
// [k_begin, k_end) of the reduction axis:
//
//   acc = A[0:rows, k_begin:k_end] @ W[k_begin:k_end, c0:c0 + BN]
//
// A is a row-major bf16 matrix in device memory (the activations or a rank
// intermediate).  W is a weight view (below).  Tiles of BK = 32 reduction
// rows move through a ring of STAGES shared-memory stages with 16-byte
// cp.async copies; cp.async.wait_group keeps STAGES - 1 stages in flight
// while the warps multiply the oldest.  Each warp owns 16 of the 128
// columns and runs mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 on
// fragments loaded with ldmatrix (.trans for W, which is stored row-major
// (K, N)).  The shared-memory rows are padded by 16 bytes, so the eight
// row addresses of an ldmatrix fall in eight different bank groups.
//
// M pads to 16 (MT = 1, 2 or 4 row tiles of 16) with zeros: rows at and
// past `rows` are zeroed once per row block (zero_pad_rows) and never
// staged.  Ragged edges -- a K slice that ends inside a stage, a column
// tile past the last column, a row whose start is not 16-byte aligned
// (C = 33, say) -- take a masked scalar path inside the same staging loop,
// which writes zeros past the edge.
//
// Weight staging goes through one hook: a view's
//   stage(Ws, k0, k_end, c0, c_end, tid)
// fills one BK x BN stage (row stride LDW_S) with rows [k0, k0 + BK) and
// columns [c0, c0 + BN) of the weight, zero at and past k_end / c_end.
// PlainB copies bf16 with cp.async.  A view that dequantizes int8 / e4m3
// factors or expands a 2:4 pack writes the converted bf16 values with
// st.shared instead and reuses everything else.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mmac {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int BM = 64;       // activation rows of one row block (4 x m16)
constexpr int BN = 128;      // output columns of a tile (8 warps x 16)
constexpr int BK = 32;       // reduction rows per stage (2 x k16)
constexpr int STAGES = 6;    // ring depth
constexpr int LDA_S = BK + 8;  // A stage row: 80 B
constexpr int LDW_S = BN + 8;  // W stage row: 272 B
constexpr int A_STAGE = BM * LDA_S;  // elements
constexpr int W_STAGE = BK * LDW_S;
constexpr size_t SMEM_BYTES =
    (size_t)STAGES * (A_STAGE + W_STAGE) * sizeof(bf16);
static_assert((BM * BK / 8) % THREADS == 0, "whole A staging passes");
static_assert((BK * BN / 8) % THREADS == 0, "whole W staging passes");
static_assert((A_STAGE * 2) % 16 == 0 && (W_STAGE * 2) % 16 == 0,
              "stages stay 16-byte aligned");

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) @ b (16x8, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Eight bf16 of shared memory from src[0 .. valid): one 16-byte cp.async
// where all eight are valid and src is 16-byte aligned, else the masked
// scalar path (zeros at and past `valid`; src is not read there).
__device__ __forceinline__ void copy_chunk(bf16* dst, const bf16* src,
                                           int valid) {
  if (valid >= 8 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    cp_async16(dst, src);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      dst[i] = i < valid ? src[i] : __float2bfloat16_rn(0.f);
  }
}

// Rows [0, rows) x columns [k0, k0 + BK) of A (row stride lda), zero at
// and past column k_end, in 16-byte chunks.
__device__ __forceinline__ void stage_a(bf16* As, const bf16* A, int lda,
                                        int rows, int k0, int k_end,
                                        int tid) {
#pragma unroll
  for (int p = 0; p < BM * BK / 8 / THREADS; ++p) {
    const int e = tid + p * THREADS;
    const int r = e / (BK / 8), c = (e % (BK / 8)) * 8;
    if (r < rows)
      copy_chunk(As + r * LDA_S + c, A + (size_t)r * lda + k0 + c,
                 k_end - (k0 + c));
  }
}

// A dense row-major bf16 weight (K rows, row stride ld).
struct PlainB {
  const bf16* w;
  int ld;
  __device__ __forceinline__ void stage(bf16* Ws, int k0, int k_end, int c0,
                                        int c_end, int tid) const {
#pragma unroll
    for (int p = 0; p < BK * BN / 8 / THREADS; ++p) {
      const int e = tid + p * THREADS;
      const int kk = e / (BN / 8), c = (e % (BN / 8)) * 8;
      bf16* dst = Ws + kk * LDW_S + c;
      if (k0 + kk < k_end)
        copy_chunk(dst, w + (size_t)(k0 + kk) * ld + c0 + c,
                   c_end - (c0 + c));
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
};

// Zero rows [rows, MT*16) of every A stage: the row padding of M to 16.
// Call between tiles (after one tile's closing barrier); the next tile's
// first barrier publishes the zeros.
template <int MT>
__device__ __forceinline__ void zero_pad_rows(bf16* smem, int rows) {
  const int per_stage = (MT * 16 - rows) * LDA_S;
  for (int e = threadIdx.x; e < STAGES * per_stage; e += THREADS) {
    const int s = e / per_stage, o = e % per_stage;
    smem[s * A_STAGE + rows * LDA_S + o] = __float2bfloat16_rn(0.f);
  }
}

// One stage of products: acc[i][j] += A rows 16i.. @ W columns
// 16*warp + 8j.. over the stage's BK rows.
template <int MT>
__device__ __forceinline__ void mma_stage(const bf16* As, const bf16* Ws,
                                          float (&acc)[MT][2][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t b[4];  // k 0-7 / 8-15 of columns 0-7, then of columns 8-15
    ldmatrix_x4_trans(b, Ws + (kk + (lane & 15)) * LDW_S + warp * 16
                             + (lane >> 4) * 8);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      uint32_t a[4];
      ldmatrix_x4(a, As + (i * 16 + (lane & 15)) * LDA_S + kk
                         + (lane >> 4) * 8);
      mma_bf16(acc[i][0], a, b[0], b[1]);
      mma_bf16(acc[i][1], a, b[2], b[3]);
    }
  }
}

// acc = A[0:rows, k_begin:k_end] @ W[k_begin:k_end, c0:c0 + BN] (columns
// at and past c_end are zero).  smem holds the ring: STAGES A stages, then
// STAGES W stages.  Every thread of the CTA calls it; it ends on a barrier,
// so the ring is free for the next tile.
template <int MT, typename WV>
__device__ __forceinline__ void tile_mma(float (&acc)[MT][2][4],
                                         const bf16* A, int lda, int rows,
                                         const WV& wv, int c0, int c_end,
                                         int k_begin, int k_end, bf16* smem) {
  bf16* As = smem;
  bf16* Ws = smem + STAGES * A_STAGE;
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  const int nk = cdiv(k_end - k_begin, BK);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      const int k0 = k_begin + s * BK;
      stage_a(As + s * A_STAGE, A, lda, rows, k0, k_end, tid);
      wv.stage(Ws + s * W_STAGE, k0, k_end, c0, c_end, tid);
    }
    cp_async_commit();  // empty groups keep the count uniform
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage kt landed
    __syncthreads();  // everyone's, and stage kt - 1 is no longer read
    const int pf = kt + STAGES - 1;
    if (pf < nk) {
      const int k0 = k_begin + pf * BK, b = pf % STAGES;
      stage_a(As + b * A_STAGE, A, lda, rows, k0, k_end, tid);
      wv.stage(Ws + b * W_STAGE, k0, k_end, c0, c_end, tid);
    }
    cp_async_commit();
    const int b = kt % STAGES;
    mma_stage<MT>(As + b * A_STAGE, Ws + b * W_STAGE, acc);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Store the tile's rows [0, rows) and columns [0, ncols) at dst (row
// stride ld): f32 as is, or rounded to bf16 (round to nearest even).  A
// thread holds column pairs (2t, 2t + 1), stored as one 8- (f32) or 4-byte
// (bf16) word where both are inside and the address is aligned.
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void put2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int MT, typename T>
__device__ __forceinline__ void store_tile(const float (&acc)[MT][2][4],
                                           T* dst, int ld, int rows,
                                           int ncols) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = i * 16 + g + h * 8;
        const int c = warp * 16 + j * 8 + t * 2;
        if (r >= rows || c >= ncols) continue;
        T* p = dst + (size_t)r * ld + c;
        const float a = acc[i][j][2 * h], b = acc[i][j][2 * h + 1];
        if (c + 1 < ncols &&
            (reinterpret_cast<uintptr_t>(p) & (2 * sizeof(T) - 1)) == 0) {
          put2(p, a, b);
        } else {
          put(p, a);
          if (c + 1 < ncols) put(p + 1, b);
        }
      }
}

// out[r, c] = round_bf16( sum_{q < nslices} P[q*slice + r*ldp + c] ) over
// rows [0, rows) and columns [0, cols), the slices summed in order (so
// the result does not depend on scheduling); every thread of the grid
// takes a stride of the elements.
__device__ __forceinline__ void reduce_slices(bf16* out, int ldo,
                                              const float* P, size_t slice,
                                              int nslices, int rows,
                                              int cols, int ldp) {
  const size_t total = (size_t)rows * cols;
  const size_t step = (size_t)gridDim.x * THREADS;
  for (size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x; e < total;
       e += step) {
    const size_t r = e / cols, c = e % cols;
    const float* p = P + r * ldp + c;
    float s = 0.f;
    int q = 0;
    for (; q + 8 <= nslices; q += 8) {  // eight loads in flight at once
      float t[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) t[j] = p[(q + j) * slice];
#pragma unroll
      for (int j = 0; j < 8; ++j) s += t[j];
    }
    for (; q < nslices; ++q) s += p[q * slice];
    out[r * ldo + c] = __float2bfloat16_rn(s);
  }
}

}  // namespace mmac
