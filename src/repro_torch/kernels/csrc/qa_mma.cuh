// Tensor-core core of the activation-quantized chain kernels (sm_90a):
// int8 x int8 products on mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32,
// exact int32 sums, in the split-phase form of branched_mma.cuh -- one
// cooperative launch of a persistent grid, every phase's work items
// spread over the whole card, grid syncs between the phases.
//
// Phases (branched_matmul_qa.cu's kernel strings them together, and
// lowrank_matmul_qa.cu's two product phases of them):
//   * quantize_rows: x (M, C) to int8 rows xq and f32 row scales xs, once
//     for all M rows, the reference's quantize_rows (absmax / 127, a safe
//     divisor of 1 for an all-zero row, rint(x / safe) clipped to +-127,
//     qa_common.cuh's quant());
//   * int_phase: items (K slice q, branch n, 128-column tile t) of
//     A_n @ W_n, each tile's int32 sum stored as a partial P[q][n][r][c];
//     int32 sums are exact, so the slices add up in any order;
//   * requant: after a grid sync, one CTA per (row, branch) segment sums
//     the segment's slices, folds each value as
//     (float(acc) * row_scale) * col_scale (__fmul_rn, nothing contracted)
//     and requantizes the segment over its own absmax;
//   * fold_y (the last product): after a grid sync, each output element
//     sums every branch's slices, folds the branch's term with its own row
//     and column scales and adds the terms in branch order from 0
//     (__fadd_rn; the lowrank chain, which has no branch sum, takes its
//     one term as it is), rounding the f32 sum to x's type once.  (Items
//     of whole column tiles running every branch, with no partials, left
//     16 to 64 CTAs streaming and lost 4-8 us a launch on an H100.)
// Every fold, division and rounding is the plain version's, so the result
// is bit-equal to it (ref.branched_matmul_qa_ref, ref.lowrank_matmul_qa_ref).
//
// The tile.  A CTA of THREADS = 256 threads (8 warps) computes an int32
// tile of up to BM = 64 rows by BN = 128 columns over one K slice; stages
// of BK = 64 reduction rows move through a ring of STAGES shared-memory
// stages by 16-byte cp.async.  Each warp owns 16 columns.
//   * A, the int8 activation rows (xq, h1q, h2q: scratch this kernel
//     writes), comes in row-major with K contiguous: ldmatrix (b16, no
//     .trans) on 16-byte row pieces gives the m16n8k32 A fragments.
//   * W, an int8 factor, is stored (K, N) with N contiguous, but the B
//     fragment wants four consecutive K bytes of one column in a register,
//     and ldmatrix.trans moves 16-bit elements only.  So the stage is read
//     with ldmatrix.x4.trans as b16: a thread gets rows 2t, 2t + 1 of
//     columns 2g, 2g + 1 from each 8-row matrix, and two __byte_perm of
//     the matrices of rows 0-7 and 8-15 give column 2g's and column
//     2g + 1's bytes at rows {2t, 2t + 1, 2t + 8, 2t + 9}.  The even
//     columns of a warp's 16 go through one mma, the odd ones through a
//     second.
//   * The K order that this gives B (within each 16 rows: 0 1 8 9, 2 3 10
//     11, 4 5 12 13, 6 7 14 15) must be A's too, so the int8 rows are
//     written in that order (kpos below) by quantize_rows and requant:
//     ldmatrix then hands each thread the same four K values of A as of
//     B.  The factors keep their layout: no transposed copy of a weight.
//   * A row of the int8 scratch is padded with zeros to a multiple of BK
//     (kpad), so an A stage never leaves it; W rows past the slice's end
//     stage as zeros, which makes the padded or foreign A bytes there
//     count 0.
// Rows past a row block's last are staged from nowhere: their sums are
// never stored.
#pragma once

#include "branched_mma.cuh"
#include "qa_common.cuh"

namespace qmma {

namespace cg = cooperative_groups;
using mmac::cdiv;
using mmac::cp_async16;
using mmac::cp_async_commit;
using mmac::cp_async_wait;
using mmac::smem_u32;

constexpr int THREADS = mmac::THREADS;  // 256, as CoopLaunch launches
constexpr int BM = mmac::BM;            // 64 rows of a row block
constexpr int BN = mmac::BN;            // 128 columns of a tile
constexpr int BK = 64;                  // int8 reduction rows per stage
constexpr int STAGES = 4;
constexpr int LDA_S = BK + 16;          // A stage row: 80 B
constexpr int LDW_S = BN + 16;          // W stage row: 144 B
constexpr int A_STAGE = BM * LDA_S;     // bytes
constexpr int W_STAGE = BK * LDW_S;
constexpr size_t SMEM = (size_t)STAGES * (A_STAGE + W_STAGE);
static_assert(BM * BK / 16 == THREADS, "one A chunk a thread a stage");
static_assert(BK * BN / 16 == 2 * THREADS, "two W chunks a thread a stage");
static_assert(A_STAGE % 16 == 0 && W_STAGE % 16 == 0,
              "stages stay 16-byte aligned");

// A row of K int8 values padded to whole stages.
__host__ __device__ __forceinline__ int kpad(int k) {
  return (k + BK - 1) / BK * BK;
}

// Where value k of an int8 activation row is stored: within each 16
// values, the order of the B fragment's rows (0 1 8 9 2 3 10 11 ...).
__device__ __forceinline__ int kpos(int k) {
  const int i = k & 15;
  return (k & ~15) | (((i & 7) >> 1) << 2) | ((i >> 3) << 1) | (i & 1);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x32, row) @ b (32x8, col), int8 in, exact int32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [0, rows) x bytes [k0, k0 + BK) of the int8 scratch A (row stride
// lda, a multiple of 16, never past its padded end) into one A stage.
__device__ __forceinline__ void stage_a(int8_t* As, const int8_t* A, int lda,
                                        int rows, int k0, int tid) {
  const int r = tid >> 2, j = tid & 3;
  if (r < rows)
    cp_async16(As + r * LDA_S + 16 * j, A + (size_t)r * lda + k0 + 16 * j);
}

// Rows [k0, k0 + BK) x columns [c0, c0 + BN) of the int8 factor W (row
// stride ldw) into one W stage: zeros at and past k_end; a piece that
// reaches past c_end or is not 16-byte aligned takes the masked byte path.
__device__ __forceinline__ void stage_w(int8_t* Ws, const int8_t* W, int ldw,
                                        int k0, int k_end, int c0, int c_end,
                                        int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int e = tid + i * THREADS;
    const int k = e >> 3, j = e & 7;
    int8_t* dst = Ws + k * LDW_S + 16 * j;
    if (k0 + k >= k_end) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const int8_t* src = W + (size_t)(k0 + k) * ldw + c0 + 16 * j;
    const int valid = c_end - c0 - 16 * j;
    if (valid >= 16 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int b = 0; b < 16; ++b) dst[b] = b < valid ? src[b] : (int8_t)0;
    }
  }
}

// One stage of products: acc[i][e] += A rows 16i.. @ W's even (e = 0) or
// odd (e = 1) columns of the warp's 16, over the stage's BK rows.
template <int MT>
__device__ __forceinline__ void mma_stage(const int8_t* As, const int8_t* Ws,
                                          int (&acc)[MT][2][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 32) {
    uint32_t w[4];  // b16 pairs of rows kk + 0-7, 8-15, 16-23, 24-31
    ldmatrix_x4_trans(w, Ws + (kk + lane) * LDW_S + warp * 16);
    const uint32_t b0e = __byte_perm(w[0], w[1], 0x6420);
    const uint32_t b0o = __byte_perm(w[0], w[1], 0x7531);
    const uint32_t b1e = __byte_perm(w[2], w[3], 0x6420);
    const uint32_t b1o = __byte_perm(w[2], w[3], 0x7531);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      uint32_t a[4];
      ldmatrix_x4(a, As + (i * 16 + (lane & 15)) * LDA_S + kk
                         + (lane >> 4) * 16);
      mma_s8(acc[i][0], a, b0e, b1e);
      mma_s8(acc[i][1], a, b0o, b1o);
    }
  }
}

// acc = A[0:rows, k_begin:k_end] @ W[k_begin:k_end, c0:c0 + BN] in int32
// (columns at and past c_end are zero).  Every thread of the CTA calls it;
// it ends on a barrier, so the ring is free for the next tile.  Each
// iteration waits for stage kt, prefetches stage kt + STAGES - 1 and
// multiplies stage kt.
template <int MT>
__device__ __forceinline__ void tile_s8(int (&acc)[MT][2][4], const int8_t* A,
                                        int lda, int rows, const int8_t* W,
                                        int ldw, int c0, int c_end,
                                        int k_begin, int k_end,
                                        unsigned char* smem) {
  int8_t* As = reinterpret_cast<int8_t*>(smem);
  int8_t* Ws = As + STAGES * A_STAGE;
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][e][q] = 0;
  const int nk = cdiv(k_end - k_begin, BK);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      const int k0 = k_begin + s * BK;
      stage_a(As + s * A_STAGE, A, lda, rows, k0, tid);
      stage_w(Ws + s * W_STAGE, W, ldw, k0, k_end, c0, c_end, tid);
    }
    cp_async_commit();  // empty groups keep the count uniform
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage kt
    __syncthreads();  // everyone's, and stage kt - 1 is no longer read
    const int pf = kt + STAGES - 1;
    if (pf < nk) {
      const int k0 = k_begin + pf * BK, b = pf % STAGES;
      stage_a(As + b * A_STAGE, A, lda, rows, k0, tid);
      stage_w(Ws + b * W_STAGE, W, ldw, k0, k_end, c0, c_end, tid);
    }
    cp_async_commit();
    const int b = kt % STAGES;
    mma_stage<MT>(As + b * A_STAGE, Ws + b * W_STAGE, acc);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Store the tile's rows [0, rows) and columns [0, ncols) at dst (row
// stride ld).  A thread holds, per row, the even mma's columns 4t, 4t + 2
// and the odd one's 4t + 1, 4t + 3 of its warp's 16: one 16-byte store
// where all four are inside and aligned.
template <int MT>
__device__ __forceinline__ void store_tile(const int (&acc)[MT][2][4],
                                           int* dst, int ld, int rows,
                                           int ncols) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int c = warp * 16 + 4 * t;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = i * 16 + g + 8 * h;
      if (r >= rows || c >= ncols) continue;
      int* p = dst + (size_t)r * ld + c;
      const int v[4] = {acc[i][0][2 * h], acc[i][1][2 * h],
                        acc[i][0][2 * h + 1], acc[i][1][2 * h + 1]};
      if (c + 4 <= ncols && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
        *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < ncols) p[j] = v[j];
      }
    }
}

// One product phase: items w = blockIdx.x, blockIdx.x + gridDim.x, ...,
// w = (K slice q, branch n, column tile t) with q = w / (nbr*tiles),
// n = (w / tiles) % nbr, t = w % tiles (qa_split's order), each
//   P[q][n][0:rows, t*BN : t*BN + BN] = A_n[:, slice q] @ W_n[slice q, ...]
// in int32, A_n = A + n*a_br (row stride lda), W_n = W + n*w_br (K x NC,
// row stride NC); P[q][n] is a rows x NC block, the blocks in (q, n)
// order.
template <int MT>
__device__ void int_phase(const int8_t* A, int lda, size_t a_br,
                          const int8_t* W, size_t w_br, int K, int NC,
                          int nbr, int kslice, int* P, int rows,
                          unsigned char* smem) {
  const int tiles = cdiv(NC, BN);
  const int nslices = cdiv(K, kslice);
  int acc[MT][2][4];
  for (int w = blockIdx.x; w < nslices * nbr * tiles; w += gridDim.x) {
    const int q = w / (nbr * tiles), n = (w / tiles) % nbr;
    const int c0 = (w % tiles) * BN, kb = q * kslice;
    tile_s8<MT>(acc, A + n * a_br, lda, rows, W + n * w_br, NC, c0, NC, kb,
                min(K, kb + kslice), smem);
    store_tile<MT>(acc, P + (size_t)(q * nbr + n) * rows * NC + c0, NC,
                   rows, NC - c0);
  }
}

// The int32 sum of value (r, c) of branch n over a phase's nslices
// partials (exact in any order), folded as the reference folds a dot:
// (float(acc) * row_scale) * col_scale.
__device__ __forceinline__ float fold(const int* P, int nslices, int nbr,
                                      int n, int rows, int NC, int r, int c,
                                      float row_scale, float col_scale) {
  const size_t slice = (size_t)nbr * rows * NC;
  const int* p = P + ((size_t)n * rows + r) * NC + c;
  int acc = 0;
#pragma unroll 16
  for (int q = 0; q < nslices; ++q) acc += __ldcg(p + q * slice);
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), row_scale), col_scale);
}

// The max of v over the CTA, for every thread; red: THREADS / 32 floats
// of shared memory, free again on return.
__device__ __forceinline__ float block_max(float v, float* red) {
  v = qa::warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = qa::warp_max(red[threadIdx.x & (THREADS / 32 - 1)]);
  __syncthreads();
  return v;
}

// Values of a segment a thread of requant holds in registers, so that
// their loads are in flight together: segments of up to RQ * THREADS =
// 1024 values; the rest of a longer one is read again.
constexpr int RQ = 4;
// Groups of 16 values of a row a thread of quantize_rows holds (rows of
// up to QG * 16 * THREADS = 8192 values take the vector path).
constexpr int QG = 2;

// 16 values of x from p (16-byte aligned), as f32.
__device__ __forceinline__ void load16(const float* p, float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p) + i);
    v[4 * i] = w.x;
    v[4 * i + 1] = w.y;
    v[4 * i + 2] = w.z;
    v[4 * i + 3] = w.w;
  }
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(p) + i);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[8 * i + 2 * j] = __uint_as_float(words[j] << 16);
      v[8 * i + 2 * j + 1] = __uint_as_float(words[j] & 0xffff0000u);
    }
  }
}

// x rows [0, M) (row stride C) to int8 rows xq (row stride kpad(C), in
// kpos order, zeros past C) and row scales xs: one CTA a row, the absmax
// reduced over the CTA.  Where C is a multiple of 16 up to 8192 and the
// rows are 16-byte aligned, a thread holds whole groups of 16 values and
// writes each group's 16 int8 values, in kpos order, as one 16-byte
// store; else one value at a time.  red: THREADS / 32 floats of shared
// memory.
template <typename T>
__device__ void quantize_rows(const T* x, int8_t* xq, float* xs, int M,
                              int C, float* red) {
  const int tid = threadIdx.x;
  const int CP = kpad(C);
  const bool vec = C % 16 == 0 && C <= QG * 16 * THREADS &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (C * sizeof(T)) % 16 == 0;
  for (int r = blockIdx.x; r < M; r += gridDim.x) {
    const T* row = x + (size_t)r * C;
    int8_t* q = xq + (size_t)r * CP;
    float m = 0.f;
    if (vec) {
      float v[QG][16];
#pragma unroll
      for (int i = 0; i < QG; ++i) {
        const int k0 = 16 * (tid + THREADS * i);
        if (k0 < C) {
          load16(row + k0, v[i]);
#pragma unroll
          for (int j = 0; j < 16; ++j) m = fmaxf(m, fabsf(v[i][j]));
        }
      }
      const float scale = __fdiv_rn(block_max(m, red), qa::QMAX);
      const float safe = qa::safe_div(scale);
#pragma unroll
      for (int i = 0; i < QG; ++i) {
        const int k0 = 16 * (tid + THREADS * i);
        if (k0 >= C) continue;
        uint32_t w[4];  // byte 4t + j holds value 2t + j (j < 2), else
                        // 8 + 2t + j - 2: kpos's order
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int vals[4] = {2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t};
          uint32_t word = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            word |= (uint32_t)(uint8_t)qa::quant(v[i][vals[j]], safe)
                    << (8 * j);
          w[t] = word;
        }
        *reinterpret_cast<uint4*>(q + k0) = make_uint4(w[0], w[1], w[2],
                                                       w[3]);
      }
      for (int k = C + 16 * tid; k < CP; k += 16 * THREADS)
        *reinterpret_cast<uint4*>(q + k) = make_uint4(0u, 0u, 0u, 0u);
      if (tid == 0) xs[r] = scale;
      continue;
    }
    for (int k = tid; k < C; k += THREADS)
      m = fmaxf(m, fabsf(lrk::to_f32(row[k])));
    const float scale = __fdiv_rn(block_max(m, red), qa::QMAX);
    const float safe = qa::safe_div(scale);
    for (int k = tid; k < CP; k += THREADS)
      q[kpos(k)] = k < C ? qa::quant(lrk::to_f32(row[k]), safe) : (int8_t)0;
    if (tid == 0) xs[r] = scale;
  }
}

// After a product phase of nslices K slices: each (row r, branch n)
// segment of NC values, folded with row scale rs[r*rs_r + n*rs_n] and
// column scales cs[n*NC + c], requantized over the segment: Hq row r,
// branch n at Hq + r*ldh + n*NCP (NCP = kpad(NC), kpos order, zeros past
// NC), its scale at Hs[r*nbr + n].  One CTA per segment, a thread per
// value; red as quantize_rows'.  (inline: two kernel sources include it.)
__device__ inline void requant(const int* P, int nslices, int nbr,
                               int rows, int NC, const float* rs, int rs_r,
                               int rs_n, const float* cs, int8_t* Hq,
                               int ldh, float* Hs, float* red) {
  const int tid = threadIdx.x;
  const int NCP = kpad(NC);
  for (int seg = blockIdx.x; seg < rows * nbr; seg += gridDim.x) {
    const int r = seg / nbr, n = seg % nbr;
    const float row_scale = __ldcg(rs + r * rs_r + n * rs_n);
    const float* col = cs + (size_t)n * NC;
    float hv[RQ];
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int c = tid + THREADS * i;
      hv[i] = c < NC ? fold(P, nslices, nbr, n, rows, NC, r, c, row_scale,
                            col[c])
                     : 0.f;
      m = fmaxf(m, fabsf(hv[i]));
    }
    for (int c = tid + THREADS * RQ; c < NC; c += THREADS)
      m = fmaxf(m, fabsf(fold(P, nslices, nbr, n, rows, NC, r, c, row_scale,
                              col[c])));
    const float scale = __fdiv_rn(block_max(m, red), qa::QMAX);
    const float safe = qa::safe_div(scale);
    int8_t* q = Hq + (size_t)r * ldh + (size_t)n * NCP;
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int c = tid + THREADS * i;
      if (c < NCP) q[kpos(c)] = c < NC ? qa::quant(hv[i], safe) : (int8_t)0;
    }
    for (int c = tid + THREADS * RQ; c < NCP; c += THREADS)
      q[kpos(c)] = c < NC ? qa::quant(fold(P, nslices, nbr, n, rows, NC, r,
                                           c, row_scale, col[c]), safe)
                          : (int8_t)0;
    if (tid == 0) Hs[r * nbr + n] = scale;
  }
}

// Branches whose partials fold_y loads together.
constexpr int MAXB = 4;

// After the last product phase (nslices K slices of each branch's K):
// y[r, s] = round_T( sum over branches n in order, from 0, of
// (float(acc_n) * hs[r*nbr + n]) * ws[n*S + s] ), rows [0, rows), every
// thread of the grid taking a stride of groups of four columns (one
// where S is not a multiple of 4), the loads of MAXB branches at once.
// from_zero false: the sum starts at the first branch's term itself, as
// a chain with no branch sum folds (0 + -0 would be +0).
template <typename T>
__device__ void fold_y(const int* P, int nslices, int nbr, int rows, int S,
                       const float* hs, const float* ws, T* y,
                       bool from_zero) {
  const int per = (S & 3) == 0 ? 4 : 1;
  const int groups = S / per;
  const size_t slice = (size_t)nbr * rows * S;
  const size_t total = (size_t)rows * groups;
  const size_t step = (size_t)gridDim.x * THREADS;
  for (size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x; e < total;
       e += step) {
    const int r = (int)(e / groups), s0 = (int)(e % groups) * per;
    float out[4] = {0.f, 0.f, 0.f, 0.f};
    for (int n0 = 0; n0 < nbr; n0 += MAXB) {
      int4 sum[MAXB];
      float h[MAXB];
#pragma unroll
      for (int j = 0; j < MAXB; ++j) {
        sum[j] = make_int4(0, 0, 0, 0);
        h[j] = n0 + j < nbr ? __ldcg(hs + r * nbr + n0 + j) : 0.f;
      }
      for (int q = 0; q < nslices; ++q)
#pragma unroll
        for (int j = 0; j < MAXB; ++j) {
          if (n0 + j >= nbr) continue;
          const int* p =
              P + q * slice + ((size_t)(n0 + j) * rows + r) * S + s0;
          if (per == 4) {
            const int4 v = __ldcg(reinterpret_cast<const int4*>(p));
            sum[j].x += v.x;
            sum[j].y += v.y;
            sum[j].z += v.z;
            sum[j].w += v.w;
          } else {
            sum[j].x += __ldcg(p);
          }
        }
#pragma unroll
      for (int j = 0; j < MAXB; ++j) {
        if (n0 + j >= nbr) continue;
        const float* w = ws + (size_t)(n0 + j) * S + s0;
        const int a[4] = {sum[j].x, sum[j].y, sum[j].z, sum[j].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i >= per) continue;
          const float t =
              __fmul_rn(__fmul_rn(__int2float_rn(a[i]), h[j]), w[i]);
          out[i] = from_zero || n0 + j > 0 ? __fadd_rn(out[i], t) : t;
        }
      }
    }
    T* dst = y + (size_t)r * S + s0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < per) dst[i] = lrk::from_f32<T>(out[i]);
  }
}

// %globaltimer (ns), for the phase timer
using mmac::global_ns;

}  // namespace qmma
