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
// Weight views.  A view addresses a stack of (R, ld) factors read as one
// (branches*R, ld) matrix: branch(n) moves it to factor n (phases 1 and 2
// of the branched kernel), and phase 3 reads the whole stack, so a row k
// belongs to branch k / R.  Its
//   stage(ring_stage, k0, k_end, c0, c_end, tid)
// puts rows [k0, k0 + BK) and columns [c0, c0 + BN) of the weight into one
// ring stage with cp.async, zero (or ignored) at and past k_end / c_end.
//   - PlainB (bf16) copies the bf16 tile straight into the stage the
//     warps multiply.
//   - DequantB (int8 / e4m3 with f32 per-column scales) and Sparse24B
//     (2:4 packs of int8 / e4m3 values, int8 row positions and scales)
//     copy their raw bytes, half or a quarter of the bf16 tile's, and the
//     scales of the stage's branch; once the stage has landed, convert()
//     writes it as bf16 (st.shared) into one of two converted tiles,
//     while the warps multiply the other (tile_mma).  Each value becomes
//     round_bf16(f32(q) * scale[col]) -- exactly 0 at a pruned 2:4 row --
//     as the TPU kernels dequantize before the dot
//     (branched_matmul_q.py:47-49, lowrank_matmul_sq.py:45 expand_tile).
//     So copies stay in flight across stages as with PlainB (STAGES - 2
//     ahead of the stage being converted).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
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
static_assert((BM * BK / 8) % THREADS == 0, "whole A staging passes");
static_assert((BK * BN / 8) % THREADS == 0, "whole W staging passes");
static_assert((A_STAGE * 2) % 16 == 0 && (W_STAGE * 2) % 16 == 0,
              "stages stay 16-byte aligned");
static_assert(STAGES >= 3, "a converting ring converts one stage ahead");

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

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
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

// Sixteen bytes of shared memory from src[0 .. valid) (a quantized
// weight's values): one 16-byte cp.async where all sixteen are valid and
// src is 16-byte aligned, else the masked scalar path (zeros at and past
// `valid`; src is not read there).  copy_floats: four f32 (scales) alike.
__device__ __forceinline__ void copy_bytes(unsigned char* dst,
                                           const unsigned char* src,
                                           int valid) {
  if (valid >= 16 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    cp_async16(dst, src);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) dst[i] = i < valid ? src[i] : 0;
  }
}

__device__ __forceinline__ void copy_floats(unsigned char* dst,
                                            const float* src, int valid) {
  if (valid >= 4 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    cp_async16(dst, src);
  } else {
    float* d = reinterpret_cast<float*>(dst);
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] = i < valid ? src[i] : 0.f;
  }
}

// A dense row-major bf16 weight: a stack of (R, ld) factors.
struct PlainB {
  static constexpr bool CONVERTS = false;
  static constexpr int RAW_STAGE = W_STAGE * sizeof(bf16);  // bytes
  const bf16* w;
  int ld, R;
  __device__ __forceinline__ PlainB branch(int n) const {
    return {w + (size_t)n * R * ld, ld, R};
  }
  __device__ __forceinline__ void stage(unsigned char* ring, int k0,
                                        int k_end, int c0, int c_end,
                                        int tid) const {
    bf16* Ws = reinterpret_cast<bf16*>(ring);
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

// k / R for a row index 0 <= k < 2^31 and a divisor R >= 1 fixed per
// launch, by one multiply-high (Granlund-Montgomery): (umulhi(k, m) + k)
// >> s with s = ceil(log2 R), m = 2^32 (2^s - R) / R + 1 (row_div
// computes both on the host).  A stage's rows find their branch with it:
// the conversion is the kernel's bottleneck, and an integer division per
// row would cost more instructions than converting the row's values.
struct RowDiv {
  int R;
  uint32_t m, s;
  __device__ __forceinline__ int operator()(int k) const {
    return (int)((__umulhi((uint32_t)k, m) + (uint32_t)k) >> s);
  }
};

inline RowDiv row_div(int R) {
  uint32_t s = 0;
  while ((1ull << s) < (unsigned long long)R) ++s;
  const uint64_t m = (((1ull << s) - (uint64_t)R) << 32) / (uint64_t)R + 1;
  return {R, (uint32_t)m, s};
}

// Four weight bytes (int8 or e4m3) as f32.
template <typename Q>
__device__ __forceinline__ void bytes_to_f32(uint32_t w, float (&f)[4]);
template <>
__device__ __forceinline__ void bytes_to_f32<int8_t>(uint32_t w,
                                                     float (&f)[4]) {
  // byte b + 128 as the low mantissa bits of 2^23: the float 2^23 + 128
  // + b, exact; subtracting 2^23 + 128 leaves b.  A byte permute and an
  // add per value, where I2F would run at a quarter of their rate.
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7440u | j)) -
           8388736.f;
}
template <>
__device__ __forceinline__ void bytes_to_f32<__nv_fp8_e4m3>(uint32_t w,
                                                            float (&f)[4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // e4m3 -> f16 is exact, f16 -> f32 too
    const __half2 p(__nv_cvt_fp8x2_to_halfraw2(
        (__nv_fp8x2_storage_t)((w >> (16 * h)) & 0xffffu), __NV_E4M3));
    const float2 v = __half22float2(p);
    f[2 * h] = v.x;
    f[2 * h + 1] = v.y;
  }
}

// round_bf16 of four f32 products, packed for one 8-byte st.shared
__device__ __forceinline__ uint2 pack_bf16x4(const float (&f)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                    *reinterpret_cast<const uint32_t*>(&hi));
}

// Columns [c, c + 4) of one branch's scale row from device memory, zero at
// and past c_end: the scales of a row whose branch is not its stage's
// first row's (phase 3 at a rank that is not a multiple of BK; not at the
// served shapes).
__device__ __forceinline__ void load_scales(const float* row, int c,
                                            int c_end, float (&s)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = c + j < c_end ? row[c + j] : 0.f;
}

// The converted tile: warp w writes rows 4w .. 4w + 3, lane l columns
// 4l .. 4l + 3 (one 8-byte store per row), so a warp writes whole rows
// and reads a stage's scales (512 contiguous bytes) once.
static_assert(BK == 4 * (THREADS / 32) && BN == 4 * 32,
              "convert: a warp takes 4 rows, a lane 4 columns");

// An int8 / e4m3 weight with one f32 scale per output column and branch:
// q a stack of (R, ld) factors, scale (branches, ld).  A ring stage holds
// the tile's BK rows (RS bytes apart), then the BN scales of the branch of
// its first row.
//
// LINES (u's view, phase 1): a row whose bytes are not a multiple of 128
// (r1 = 192, 448, 480, 608 int8) puts most column tiles across two
// 128-byte lines, each shared with the neighbouring tile's CTA, and such
// partial-line reads ran phase 1 at about half the rate of line-aligned
// rows on the H100 (chip_smoke's "ds o, r 512" control row beside "ds o"
// shows what is left of it for each view).  So where rows start 16-byte
// aligned but not all on a line, a row is fetched as the whole lines that
// hold its tile (one or two) and converted from its offset in them,
// columns past the tile masked.  The check and the masks cost
// instructions, which the other phases (rows of S, aligned, or a small
// xc) do not repay, so their views stage the tile's own bytes.  Ragged
// rows take the masked scalar path at offset 0.
template <typename Q, bool LINES = false>
struct DequantB {
  static constexpr bool CONVERTS = true;
  static constexpr int RS = LINES ? 2 * BN : BN;       // a staged row
  static constexpr int VALUES = BK * RS;               // bytes
  static constexpr int RAW_STAGE = VALUES + BN * 4;    // then the scales
  static_assert(BK * (BN / 16) == THREADS, "a thread per 16 bytes of tile");
  const Q* q;
  const float* scale;
  int ld;
  RowDiv R;  // rows per branch
  __device__ __forceinline__ DequantB branch(int n) const {
    return {q + (size_t)n * R.R * ld, scale + (size_t)n * ld, ld, R};
  }
  __device__ __forceinline__ int branch_of(int k) const {
    return k < R.R ? 0 : R(k);
  }
  // rows 16-byte aligned, not all on a line: fetch whole lines
  __device__ __forceinline__ bool lines() const {
    const uintptr_t a = reinterpret_cast<uintptr_t>(q) | (uintptr_t)ld;
    return LINES && (a & 15) == 0 && (a & 127) != 0;
  }
  // where row k's tile starts in its staged row
  __device__ __forceinline__ int offset(int k, int c0) const {
    return lines() ? (int)(((uint32_t)reinterpret_cast<uintptr_t>(q) +
                            (uint32_t)k * (uint32_t)ld + (uint32_t)c0) &
                           127u)
                   : 0;
  }
  __device__ __forceinline__ void stage(unsigned char* ring, int k0,
                                        int k_end, int c0, int c_end,
                                        int tid) const {
    const int kk = tid / (BN / 16), j = tid % (BN / 16);
    if (k0 + kk < k_end) {
      const int width = min(BN, c_end - c0);  // the tile's bytes in a row
      const uintptr_t a =
          reinterpret_cast<uintptr_t>(q + (size_t)(k0 + kk) * ld + c0);
      unsigned char* dst = ring + kk * RS + 16 * j;
      if (lines()) {  // chunk j of the first line, and of the second
        const uintptr_t w = (a & ~uintptr_t(127)) + 16 * j;
        cp_async16(dst, reinterpret_cast<const void*>(w));
        if ((int)(a & 127) + width > 128)
          cp_async16(dst + 128, reinterpret_cast<const void*>(w + 128));
      } else {
        copy_bytes(dst, reinterpret_cast<const unsigned char*>(a) + 16 * j,
                   width - 16 * j);
      }
    }
    if (tid < BN / 4)
      copy_floats(ring + VALUES + 16 * tid,
                  scale + (size_t)branch_of(k0) * ld + c0 + 4 * tid,
                  c_end - (c0 + 4 * tid));
  }
  // columns c .. c + 3 of a staged row (src), times scales s; with LINES,
  // zero at and past column `width` of the tile (fetched lines hold the
  // next tile's or row's bytes there; staged tile bytes are zero there,
  // and so are the scales)
  __device__ __forceinline__ static uint2 row(const unsigned char* src,
                                              int c, int width,
                                              const float (&s)[4]) {
    float f[4];
    bytes_to_f32<Q>(*reinterpret_cast<const uint32_t*>(src), f);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[j] = !LINES || c + j < width ? __fmul_rn(f[j], s[j]) : 0.f;
    return pack_bf16x4(f);
  }
  __device__ __forceinline__ void convert(bf16* Wc, const unsigned char* ring,
                                          int k0, int k_end, int c0,
                                          int c_end, int tid) const {
    const int warp = tid >> 5, c = 4 * (tid & 31);
    const int k = k0 + 4 * warp;  // the warp's first row
    const int width = min(BN, c_end - c0);
    const float4 s4 =
        *reinterpret_cast<const float4*>(ring + VALUES + 4 * c);
    const float s[4] = {s4.x, s4.y, s4.z, s4.w};
    const int b0 = branch_of(k0);
    const unsigned char* src = ring + 4 * warp * RS + c;
    if (k + 3 < k_end && branch_of(k + 3) == b0) {  // the common case
#pragma unroll
      for (int t = 0; t < 4; ++t)
        *reinterpret_cast<uint2*>(Wc + (4 * warp + t) * LDW_S + c) =
            row(src + t * RS + offset(k + t, c0), c, width, s);
      return;
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {  // past k_end, or another branch's rows
      uint2 out = make_uint2(0u, 0u);
      if (k + t < k_end) {
        const int b = branch_of(k + t);
        float sb[4] = {s[0], s[1], s[2], s[3]};
        if (b != b0)
          load_scales(scale + (size_t)b * ld + c0, c, c_end - c0, sb);
        out = row(src + t * RS + offset(k + t, c0), c, width, sb);
      }
      *reinterpret_cast<uint2*>(Wc + (4 * warp + t) * LDW_S + c) = out;
    }
  }
};

// A stack of (R, ld) factors each packed 2:4 along R, slot-major as the
// reference packs it (repro/quant/sparse.py): per branch, sp (2, R/4, ld)
// int8 or e4m3 kept values, idx (2, R/4) int8 within-group row positions,
// scale (ld) f32.  Row 4g + t of column j is round_bf16(v * scale[j]), v
// the f32 sum of the slots i whose idx[i][g] == t (sp[i][g][j]), as
// expand_tile's where-sum does, and exactly 0 where no slot holds it: a
// pruned row is an explicit zero in the product, so a non-finite
// activation meeting it still spreads, as in the reference's dense dot.
// A stage's BK rows are BK / 4 groups (R is a multiple of 4, so a group
// never straddles a branch or a stage); its ring stage holds the groups'
// two value rows per slot, one 4-byte word holding each (slot, group)'s
// index byte (cp.async takes no single bytes), and the scales of the
// branch of its first row.
template <typename Q>
struct Sparse24B {
  static constexpr bool CONVERTS = true;
  static constexpr int GROUPS = BK / 4;
  static constexpr int VALUES = 2 * GROUPS * BN;       // [slot][group][col]
  static constexpr int WORDS = 2 * GROUPS * 4;         // [slot][group] u32
  static constexpr int RAW_STAGE = VALUES + WORDS + BN * 4;
  static constexpr int VALUE_CHUNKS = VALUES / 16;     // threads that copy
  static_assert(VALUE_CHUNKS + 2 * GROUPS + BN / 4 <= THREADS,
                "one copy per thread");
  static_assert(GROUPS == THREADS / 32, "convert: one group per warp");
  const Q* sp;
  const int8_t* idx;
  const float* scale;
  int ld;
  RowDiv R;  // rows per branch
  __device__ __forceinline__ Sparse24B branch(int n) const {
    return {sp + (size_t)n * (R.R / 2) * ld, idx + (size_t)n * (R.R / 2),
            scale + (size_t)n * ld, ld, R};
  }
  __device__ __forceinline__ int branch_of(int k) const {
    return k < R.R ? 0 : R(k);
  }
  // slot i's index byte of the group holding row k of branch b
  __device__ __forceinline__ const int8_t* index_at(int i, int k,
                                                    int b) const {
    return idx + (size_t)b * (R.R / 2) + i * (R.R / 4) + (k - b * R.R) / 4;
  }
  __device__ __forceinline__ void stage(unsigned char* ring, int k0,
                                        int k_end, int c0, int c_end,
                                        int tid) const {
    if (tid < VALUE_CHUNKS) {
      const int row = tid / (BN / 16), c = (tid % (BN / 16)) * 16;
      const int i = row / GROUPS, k = k0 + 4 * (row % GROUPS);
      if (k < k_end) {
        const int b = branch_of(k);
        const Q* src = sp + (size_t)b * (R.R / 2) * ld +
                       ((size_t)i * (R.R / 4) + (k - b * R.R) / 4) * ld +
                       c0 + c;
        copy_bytes(ring + row * BN + c,
                   reinterpret_cast<const unsigned char*>(src),
                   c_end - (c0 + c));
      }
    } else if (tid < VALUE_CHUNKS + 2 * GROUPS) {
      const int e = tid - VALUE_CHUNKS;
      const int k = k0 + 4 * (e % GROUPS);
      if (k < k_end) {  // the aligned word around the byte
        const uintptr_t a = reinterpret_cast<uintptr_t>(
            index_at(e / GROUPS, k, branch_of(k)));
        cp_async4(ring + VALUES + 4 * e,
                  reinterpret_cast<const void*>(a & ~uintptr_t(3)));
      }
    } else if (tid < VALUE_CHUNKS + 2 * GROUPS + BN / 4) {
      const int e = tid - VALUE_CHUNKS - 2 * GROUPS;
      copy_floats(ring + VALUES + WORDS + 16 * e,
                  scale + (size_t)branch_of(k0) * ld + c0 + 4 * e,
                  c_end - (c0 + 4 * e));
    }
  }
  __device__ __forceinline__ void convert(bf16* Wc, const unsigned char* ring,
                                          int k0, int k_end, int c0,
                                          int c_end, int tid) const {
    const int gg = tid >> 5, c = 4 * (tid & 31);
    const int k = k0 + 4 * gg;
    uint2* out = reinterpret_cast<uint2*>(Wc + 4 * gg * LDW_S + c);
    constexpr int ROW = LDW_S / 4;  // a converted row, in uint2
    if (k >= k_end) {
#pragma unroll
      for (int t = 0; t < 4; ++t) out[t * ROW] = make_uint2(0u, 0u);
      return;
    }
    const float4 s4 =
        *reinterpret_cast<const float4*>(ring + VALUES + WORDS + 4 * c);
    float s[4] = {s4.x, s4.y, s4.z, s4.w};
    const int b = branch_of(k);
    if (b != branch_of(k0))
      load_scales(scale + (size_t)b * ld + c0, c, c_end - c0, s);
    int at[2];
    float v[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t word = *reinterpret_cast<const uint32_t*>(
          ring + VALUES + 4 * (i * GROUPS + gg));
      const int shift =
          8 * (int)(reinterpret_cast<uintptr_t>(index_at(i, k, b)) & 3);
      at[i] = (int8_t)((word >> shift) & 0xffu);
      bytes_to_f32<Q>(*reinterpret_cast<const uint32_t*>(
                          ring + (i * GROUPS + gg) * BN + c),
                      v[i]);
    }
    if (at[0] == at[1]) {
      // both slots name one row (a pack not made by sparsify_array):
      // their f32 sum, as expand_tile's where-sum
#pragma unroll
      for (int j = 0; j < 4; ++j) v[0][j] = __fadd_rn(v[0][j], v[1][j]);
      at[1] = -1;
    }
    // each row holds one slot or none: round_bf16(v * s) of its slot (f32
    // 0 + v is v), or 0
    uint2 slot[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[i][j] = __fmul_rn(v[i][j], s[j]);
      slot[i] = pack_bf16x4(v[i]);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
      out[t * ROW] = at[0] == t   ? slot[0]
                     : at[1] == t ? slot[1]
                                  : make_uint2(0u, 0u);
  }
};

// Dynamic shared memory of a tile of view WV: the A stages, the weight
// stages and, for a converting view, two converted tiles.
template <typename WV>
__host__ __device__ constexpr size_t tile_smem() {
  return (size_t)STAGES * (A_STAGE * sizeof(bf16) + WV::RAW_STAGE) +
         (WV::CONVERTS ? 2 * W_STAGE * sizeof(bf16) : 0);
}
static_assert(DequantB<int8_t, true>::RAW_STAGE % 16 == 0 &&
                  DequantB<int8_t>::RAW_STAGE % 16 == 0 &&
                  Sparse24B<int8_t>::RAW_STAGE % 16 == 0,
              "stages stay 16-byte aligned");

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
// at and past c_end are zero).  smem holds the ring: STAGES A stages,
// then STAGES weight stages of WV::RAW_STAGE bytes, then, for a converting
// view, two converted tiles.  Every thread of the CTA calls it; it ends on a
// barrier, so the ring is free for the next tile.
//
// PlainB: each iteration waits for stage kt, prefetches stage kt + STAGES - 1
// and multiplies stage kt.  A converting view: each iteration waits for
// stage kt + 1, prefetches stage kt + STAGES - 1, converts stage kt + 1 into
// one converted tile and multiplies stage kt from the other (converted
// one iteration before), so one barrier per stage separates them, and a
// warp's conversion overlaps its products.
template <int MT, typename WV>
__device__ __forceinline__ void tile_mma(float (&acc)[MT][2][4],
                                         const bf16* A, int lda, int rows,
                                         const WV& wv, int c0, int c_end,
                                         int k_begin, int k_end,
                                         unsigned char* smem) {
  bf16* As = reinterpret_cast<bf16*>(smem);
  unsigned char* Wr = smem + (size_t)STAGES * A_STAGE * sizeof(bf16);
  bf16* Wc = reinterpret_cast<bf16*>(Wr + (size_t)STAGES * WV::RAW_STAGE);
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
      wv.stage(Wr + s * WV::RAW_STAGE, k0, k_end, c0, c_end, tid);
    }
    cp_async_commit();  // empty groups keep the count uniform
  }
  if constexpr (WV::CONVERTS) {
    cp_async_wait<STAGES - 2>();  // stage 0 landed
    __syncthreads();
    wv.convert(Wc, Wr, k_begin, k_end, c0, c_end, tid);
  }
  for (int kt = 0; kt < nk; ++kt) {
    if constexpr (WV::CONVERTS) {
      // this thread's copies of stage kt + 1 landed; after the barrier,
      // everyone's, converted tile kt % 2 is written, and stage kt - 1
      // and converted tile (kt + 1) % 2 are no longer read
      cp_async_wait<STAGES - 3>();
    } else {
      cp_async_wait<STAGES - 2>();  // this thread's copies of stage kt landed
    }
    __syncthreads();  // everyone's, and stage kt - 1 is no longer read
    const int pf = kt + STAGES - 1;
    if (pf < nk) {
      const int k0 = k_begin + pf * BK, b = pf % STAGES;
      stage_a(As + b * A_STAGE, A, lda, rows, k0, k_end, tid);
      wv.stage(Wr + b * WV::RAW_STAGE, k0, k_end, c0, c_end, tid);
    }
    cp_async_commit();
    const int b = kt % STAGES;
    if constexpr (WV::CONVERTS) {
      if (kt + 1 < nk)
        wv.convert(Wc + ((kt + 1) & 1) * W_STAGE,
                   Wr + ((kt + 1) % STAGES) * WV::RAW_STAGE,
                   k_begin + (kt + 1) * BK, k_end, c0, c_end, tid);
      mma_stage<MT>(As + b * A_STAGE, Wc + (kt & 1) * W_STAGE, acc);
    } else {
      mma_stage<MT>(As + b * A_STAGE,
                    reinterpret_cast<const bf16*>(Wr + b * WV::RAW_STAGE),
                    acc);
    }
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
