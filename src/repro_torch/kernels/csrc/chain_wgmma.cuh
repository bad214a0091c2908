// The large-M form of the bf16 chain kernels (sm_90a): B1
//   y = rnd( rnd(x @ w0) @ w1 )                            (lowrank_matmul)
// and B2
//   y = rnd( sum_n rnd( rnd(x @ u_n) @ xc_n ) @ v_n )     (branched_matmul)
// over hundreds to thousands of activation rows (fine-tuning's M = 1,024,
// hubert's 2,000 frames, the VLM's 1,601 image tokens), and of the same
// chains on int8 / e4m3 factors, B3 (lowrank_matmul_q) and B4
// (branched_matmul_q), with every factor value dq(q) = rnd(f32(q) *
// scale[col]) (scales per output column, and per branch).  rnd is the cast
// to bf16; every product accumulates in f32, and B2's branch sum is taken
// in f32 and rounded once.
//
// Replaces, at M >= LARGE_M (kernels/branched_matmul.py), the TPU kernels
// src/repro/kernels/lowrank_matmul.py::lowrank_matmul (pallas_call at :68)
// and src/repro/kernels/branched_matmul.py::branched_matmul (:69), and, at
// M >= LARGE_M_Q, lowrank_matmul_q.py::lowrank_matmul_q (:75) and
// branched_matmul_q.py::branched_matmul_q (:90).  They keep h (B1) and
// each branch's h1 / h2 (B2) in VMEM per row block, to save the HBM round
// trip at M ~ 1e6, and the quantized ones dequantize each weight tile in
// VMEM right before its dot: no dequantized weight goes through HBM.
// Their roundings are kept exactly (lowrank_matmul.py:45-47,
// branched_matmul.py:37-39, 51-53, lowrank_matmul_q.py:41-49,
// branched_matmul_q.py:48-50).
//
// What bounds it on an H100: at these M the chains do 2*M*(C*R + R*S)
// (B2: 2*M*N*(C*r1 + r1*r2 + r2*S)) operations on (M*(C + S) + weights)*2
// bytes, hundreds of operations a byte: the tensor cores' 989 TFLOP/s,
// not the 3.35 TB/s, set the bound (hubert's B2 up, the train step's B2).
// So each product must run as a whole-card tensor-core GEMM, which the
// split-phase kernel (branched_mma.cuh) cannot: it walks 64-row blocks one
// after another, reads every weight again per block and ends each phase on
// a grid sync.
//
// Design: every product of the chain is one launch of an output-tiled
// GEMM, on the current stream, in order:
//   B1: h = rnd(x @ w0) into an (M, R) bf16 scratch; y = rnd(h @ w1);
//   B2: h1[:, n] = rnd(x @ u_n) for every branch n (one tile space over the
//       N*r1 columns: the tile's branch picks u_n); h2[:, n] = rnd(h1_n @
//       xc_n) (N grouped products in one tile space); y = rnd(h2 @ v), v
//       read as one (N*r2, S) matrix: the branch sum is the K loop, in f32,
//       rounded once.  B2's first two products are not fused: h1 goes
//       through the scratch (below) like h2.
// A CTA owns one BM x BN output tile (128 x 128; BN 64 where 128-wide
// tiles would leave SMs idle or pad a branch, and then BM 64 where the
// card is still not full).  One thread of a producer warp keeps a ring of
// 3-6 stages of A (BM x 64) and B (64 x BN) tiles in flight in shared
// memory, each a TMA load (cp.async.bulk.tensor, zeros past every edge:
// the ragged last row tile, a branch's last K block, a column tile past N)
// completing on the stage's mbarrier.  One consumer warpgroup a 64-row
// half runs wgmma.mma_async m64nBNk16 (bf16 in, f32 in registers) from the
// ring, A K-major and B MN-major (the factors are stored (K, N),
// row-major), 128-byte swizzled; each keeps one wgmma group in flight and
// releases the stage before it.  Where a product has more tiles than the
// card has SMs, the ring is shallower and two CTAs share an SM, so one's
// prologue and epilogue overlap the other's products; else it is 6 deep,
// one CTA an SM.  The epilogue rounds each f32 sum to bf16 once and stores
// it straight from the registers, clipped to (M, N).  Products run in
// order as separate launches: a tile of phase k+1 reads whole rows of
// phase k's output, and the stream orders them without a grid-wide sync
// (a persistent launch with per-row-block counters would save the 2-5 us
// between launches; not done).
//
// bf16 factors (B1 / B2, chain_gemm_kernel): B comes by TMA as two 64-column
// boxes with the 128-byte swizzle, read by wgmma where it lands; a CTA
// loops over the whole K (and the branches of a summing product): no K
// slices, no atomics.
//
// int8 / e4m3 factors (B3 / B4, chain_gemm_q_kernel): B comes by TMA as
// its bytes (one BN-byte-wide box of 64 rows a stage, with TMA's 64- or
// 128-byte swizzle; half the bf16 tile's bytes) and never goes back to
// shared memory as bf16: the product is computed transposed, y^T =
// dq(W)^T x^T, the weight tile as wgmma's A operand from registers and x's
// tile (the ring's, K-major) as its B operand.  Each consumer thread
// builds its A fragments from four 16-bit shared loads a k16 step (its two
// output columns at four K rows; the swizzle puts a warp's loads on
// distinct banks): exact conversions (int8 through the float 2^23 + 128 +
// b; e4m3 through f16), __fmul_rn by the column's f32 scale and a round to
// nearest even -- the bits of dq() above and of the dequantizing pass
// (chain_dequant.cu) that the form ran before, which wrote every factor as
// bf16 into scratch first (3 bytes a weight value, 28-30 % of the VLM's B4
// call at M = 512).  A warp's 16 A rows are permuted (row g: column 2g,
// row g + 8: column 2g + 1), so a thread's two columns are adjacent: one
// load a K row, and each output row gets a 4-byte pair.  A stage's four
// fragments are built while the stage before's four wgmmas (one commit
// group) run; two sets in turn.  Tiles: BN columns of one (64) or two
// (128, sharing x's tile) consumer warpgroups by BM rows, the wgmma's N
// (64-256: a converted weight value serves BM rows); the plan picks them
// (kernels/branched_matmul.py::_q_tile).  The scales: two a thread, loaded
// before the first stage lands and again where a summing product's K loop
// enters the next branch.
// What the card showed on the way (PERF.md): converting into a bf16 tile
// in shared memory for wgmma to read (by the consumers a stage ahead, or
// by a converter warpgroup) ran 1.1-1.8x slower than the earlier
// pass-then-products design; fragments built a k16 step at a time, one
// commit group a step, and 16-byte-wide TMA boxes of the bytes (64
// requests a kilobyte) each cost more than the conversion.
//
// K slices (quantized products only): where a product's tiles fill less
// than half the CTA slots its tile has (SMs x CTAs an SM: the VLM's k,v
// first product has 48 tiles of 64 x 64 at M = 512, 12 at M = 128, over
// 128 K blocks), its K loop -- for B4's last product the branches x K
// blocks, a slice may straddle two branches -- is cut into whole-BK
// slices, none empty, about as many CTAs as slots (kernels/
// branched_matmul.py::_k_slice).  Each slice stores its f32 partial tile
// in scratch; the last CTA of a tile (a ticket on an int32 of
// build.tickets, taken after a __threadfence) adds the partials in slice
// order, 0 first (a slice's values loaded together), rounds once to bf16,
// stores the tile and sets the ticket back to 0.  No float atomics: a call
// gives the same bits every run, and a product of one slice runs the bf16
// loop's sums, so a call none of whose products slices is bit-equal to B1
// / B2 on the dequantized factors (the tensor cores sum a k16 step's
// products of the transposed tile as of the tile: the card's check of the
// bits says so).
//
// The scratch: h (B1) and h1, h2 (B2) go through device memory, at most
// R / C of x's bytes (hubert: 2,000 x 256 bf16 = 1 MB against x's 5 MB);
// written by one launch and read by the next, they stay in the 50 MB L2.
// Operands whose row is not a whole number of 16-byte granules (TMA's
// stride rule: the searched k/v rank 191, 382 bytes in bf16, 191 in int8),
// or whose base is not 16-byte aligned, are copied by the wrapper into
// padded rows of the scratch first (int8 factors as bytes); the
// intermediates are laid out padded from the start.
#pragma once

// CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wgc {

using bf16 = __nv_bfloat16;

// A tile of BM = 64 x WG rows (WG consumer warpgroups of 64 rows each, 1
// or 2) by BN columns (64 or 128).
constexpr int BK = 64;              // reduction depth of a stage: 128 B
constexpr int MAX_STAGES = 6;       // deepest ring (the plan picks 3-6)
constexpr int CHUNK = BK * 64 * 2;  // bytes of one 64-column box of B

// threads of a CTA: the consumer warpgroups and the producer warp
template <int WG>
__host__ __device__ constexpr int threads() { return WG * 128 + 32; }

// bytes of a stage: the A tile (64 WG rows x BK) and the B tile (BK x BN)
template <int BN, int WG>
__host__ __device__ constexpr int stage_bytes() {
  return 64 * WG * BK * 2 + BK * BN * 2;
}

// Dynamic shared memory of a launch: a ring of `stages` stages, its
// 2 x stages mbarriers and the slack that aligns the ring to the 1,024
// bytes of a swizzle pattern.
template <int BN, int WG>
constexpr size_t smem_bytes(int stages) {
  return 1024 + (size_t)stages * stage_bytes<BN, WG>() + 2 * stages * 8;
}
static_assert((64 * BK * 2) % 1024 == 0 && CHUNK % 1024 == 0,
              "every tile starts on a swizzle pattern");

// A quantized launch's stage: the BM x BK bf16 x tile and the B tile's
// BK x BN bytes as BN / 16 boxes of BK rows x 16 bytes.
template <int BM, int BN>
__host__ __device__ constexpr int q_stage_bytes() {
  return BM * BK * 2 + BK * BN;
}

// The shared memory a block may take on an H100 (227 KB), opted into by
// the quantized launches, whose ring depth the plan sizes to fit it.
constexpr int SMEM_OPT_IN = 232448;

// Dynamic shared memory of a quantized launch: the ring, its mbarriers,
// the fold's flag and the alignment slack.
template <int BM, int BN>
constexpr size_t q_smem_bytes(int stages) {
  return 1024 + (size_t)stages * q_stage_bytes<BM, BN>() + 2 * stages * 8 +
         16;
}
static_assert(q_stage_bytes<64, 64>() % 1024 == 0,
              "every x tile starts on a swizzle pattern");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA load of a box of a 3-D tensor map at (c0, c1, c2), innermost
// first, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Brings a tensor map (a kernel parameter) into the TMA unit's cache ahead
// of its first load.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)) : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled tile at `addr`:
// lbo / sbo the byte strides between 8 x 128-byte swizzle atoms along the
// leading and the strided dimension (PTX ISA, matrix descriptor).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma that owns them.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16, K-major) @ B (16 x 128, MN-major: imm-trans-b 1),
// both in shared memory behind their descriptors; scale_d 0 drops d
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A (64 x 16, K-major) @ B (16 x 64, MN-major: imm-trans-b 1),
// both in shared memory behind their descriptors; scale_d 0 drops d
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t da,
                                    uint64_t db) {
  if constexpr (BN == 128)
    wgmma_n128(d, da, db, 1);
  else
    wgmma_n64(d, da, db, 1);
}

// d += A (64 x 16, bf16 pairs in registers, the mma.m16n8k16 A fragment
// of each warp's 16 rows) @ B (16 x 128, K-major in shared memory behind
// its descriptor: imm-trans-b 0)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// The same with B 16 x 256
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// The same with B 16 x 64
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t* a,
                                       uint64_t db) {
  if constexpr (N == 256)
    wgmma_rs_n256(d, a, db);
  else if constexpr (N == 128)
    wgmma_rs_n128(d, a, db);
  else
    wgmma_rs_n64(d, a, db);
}

// Stores a quantized launch's transposed sums: accumulator d[4j + 2h + e]
// is output row m0 + 8j + 2 tq + e, column n + h (n even), each rounded
// to bf16 once, the pair in one 4-byte store; clipped to (M, N).
template <int BM>
__device__ __forceinline__ void store_pairs(const float (&acc)[BM / 2],
                                            bf16* out, long long ldc, int m0,
                                            int n, int tq, int M, int N) {
  if (n >= N) return;
#pragma unroll
  for (int j = 0; j < BM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * j + 2 * tq + e;
      if (m >= M) continue;
      bf16* p = out + (long long)m * ldc + n;
      const float v0 = acc[4 * j + e], v1 = acc[4 * j + 2 + e];
      if (n + 1 < N && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
      } else {
        p[0] = __float2bfloat16_rn(v0);
        if (n + 1 < N) p[1] = __float2bfloat16_rn(v1);
      }
    }
}

// One (64 WG) x BN output tile per CTA: tile (blockIdx.x, blockIdx.y) of
// output group z = blockIdx.z,
//   c[z*c_group + m*ldc + n] = rnd( sum_{s < sum_groups} sum_{k < K}
//                                   A_g[m, k] * B_g[k, n] ),  g = z + s
// (one of out groups and sum_groups is 1).  amap: A as (K, groups of A,
// M), bmap: B as (N, K, groups of B), both bf16 with 128-byte swizzle and
// boxes (64, 1, 128) and (64, 64, 1); a_grouped: A has a group per g
// (else its one group serves every g).  Rows >= M and columns >= N are
// loaded as zeros and not stored.  stages: the ring's depth; at 3 (BN
// 128) or 4 (BN 64) two CTAs share an SM, so one's prologue and epilogue
// overlap the other's products.
template <int BN, int WG>
__global__ void __launch_bounds__(threads<WG>(), 2)
chain_gemm_kernel(const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap bmap,
                  bf16* __restrict__ c, long long ldc, long long c_group,
                  int M, int N, int K, int sum_groups, int a_grouped,
                  int stages) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + stages * stage_bytes<BN, WG>());
  uint64_t* empty = full + stages;
  const int kblocks = (K + BK - 1) / BK;
  const int iters = kblocks * sum_groups;
  constexpr int A_STAGE = 64 * WG * BK * 2;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * 64 * WG, z = blockIdx.z;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == WG) {
    // the producer warp: one thread issues every load of the ring
    if (threadIdx.x == WG * 128) {
      for (int it = 0; it < iters; ++it) {
        const int s = it % stages;
        if (it >= stages) mbar_wait(&empty[s], (it / stages - 1) & 1);
        const int g = z + it / kblocks, k0 = (it % kblocks) * BK;
        unsigned char* st = smem + s * stage_bytes<BN, WG>();
        mbar_expect_tx(&full[s], stage_bytes<BN, WG>());
        tma_load_3d(st, &amap, &full[s], k0, a_grouped ? g : 0, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_3d(st + A_STAGE + j * CHUNK, &bmap, &full[s], n0 + 64 * j,
                      k0, g);
      }
    }
    return;
  }

  // a consumer warpgroup: rows [m0 + 64 wg, m0 + 64 wg + 64) of the tile
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < iters; ++it) {
    const int s = it % stages;
    mbar_wait(&full[s], (it / stages) & 1);
    const uint32_t st = smem_u32(smem + s * stage_bytes<BN, WG>());
    const uint32_t a = st + wg * 64 * 128, b = st + A_STAGE;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      // A: K-major, 8-row atoms 1,024 B apart, k16 = 32 B along the row;
      // B: MN-major, 64-column boxes CHUNK apart, 8-row atoms 1,024 B
      // apart, k16 = two atoms
      mma<BN>(acc, desc(a + kk * 32, 16, 1024),
              desc(b + kk * 2048, CHUNK, 1024));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    // the products of the stage before are done: give it back
    if (it > 0 && threadIdx.x % 128 == 0)
      mbar_arrive(&empty[(it - 1) % stages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: accumulator d[4j + 2h + e] is row 16 warp + lane/4 + 8h,
  // column 8j + 2 (lane % 4) + e of the warpgroup's 64 x BN tile
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
  bf16* out = c + z * c_group;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + j * 8 + (lane % 4) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + h * 8;
      if (row >= M || col >= N) continue;
      bf16* p = out + (long long)row * ldc + col;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (col + 1 < N && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
      } else {
        p[0] = __float2bfloat16_rn(v0);
        if (col + 1 < N) p[1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

// A barrier of the consumer threads alone (the producer warp has left).
template <int N>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from reusing a fragment's registers while a wgmma
// that reads them may be in flight.
__device__ __forceinline__ void fence_frag(uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// Two values of a quantized B (the bytes of a 16-bit word, the lowest
// first) as f32, exactly.
template <typename Q>
__device__ __forceinline__ float2 pair_to_f32(uint32_t w);
template <>
__device__ __forceinline__ float2 pair_to_f32<int8_t>(uint32_t w) {
  // byte b + 128 as the low mantissa bits of 2^23: the float 2^23 + 128
  // + b, exact; subtracting 2^23 + 128 leaves b.  A byte permute and an
  // add per value, where I2F runs at a quarter of their rate.
  const uint32_t u = w ^ 0x8080u;
  return make_float2(
      __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7440u)) - 8388736.f,
      __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7441u)) - 8388736.f);
}
template <>
__device__ __forceinline__ float2 pair_to_f32<__nv_fp8_e4m3>(uint32_t w) {
  // e4m3 -> f16 is exact, f16 -> f32 too
  return __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
      (__nv_fp8x2_storage_t)(w & 0xffffu), __NV_E4M3)));
}

// rnd_bf16(f32(q) * scale) of two values, rounded to nearest in f32 and
// to nearest even in bf16, packed (x in the low half)
__device__ __forceinline__ uint32_t dq_pack(float x, float sx, float y,
                                            float sy) {
  const __nv_bfloat162 v =
      __floats2bfloat162_rn(__fmul_rn(x, sx), __fmul_rn(y, sy));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The thread's A fragment of one k16 step of a quantized B, from the
// stage's bytes: the weight tile is wgmma's A operand (rows: output
// columns, from registers) and x its B operand, so the warpgroup computes
// the transposed tile.  A row r of warp w's 16 is output column 16 w + 2 g
// (r = g < 8) or 16 w + 2 g + 1 (r = g + 8), so a thread's two rows are
// adjacent columns: one 16-bit shared load a K row gives both, and the
// sums of both sit in one register pair.  `w`: the step's 16 rows of the
// stage's B bytes; `o`: the offsets of the thread's column pair in rows
// 2t, 2t + 1, 2t + 8, 2t + 9 of them (TMA's swizzle puts a warp's loads on
// distinct banks); `sc`: the pair's scales.
//   a[0] = (col 2g, k 2t, 2t+1)   a[1] = (col 2g+1, k 2t, 2t+1)
//   a[2] = (col 2g, k 2t+8, +9)   a[3] = (col 2g+1, k 2t+8, +9)
template <typename Q>
__device__ __forceinline__ void load_frag(const unsigned char* w,
                                          const int (&o)[4], float2 sc,
                                          uint32_t* a) {
  const uint32_t k0 = *reinterpret_cast<const uint16_t*>(w + o[0]);
  const uint32_t k1 = *reinterpret_cast<const uint16_t*>(w + o[1]);
  const uint32_t k8 = *reinterpret_cast<const uint16_t*>(w + o[2]);
  const uint32_t k9 = *reinterpret_cast<const uint16_t*>(w + o[3]);
  const float2 v0 = pair_to_f32<Q>(k0), v1 = pair_to_f32<Q>(k1);
  const float2 v8 = pair_to_f32<Q>(k8), v9 = pair_to_f32<Q>(k9);
  a[0] = dq_pack(v0.x, sc.x, v1.x, sc.x);
  a[1] = dq_pack(v0.y, sc.y, v1.y, sc.y);
  a[2] = dq_pack(v8.x, sc.x, v9.x, sc.x);
  a[3] = dq_pack(v8.y, sc.y, v9.y, sc.y);
}

// The quantized form of chain_gemm_kernel: B_g[k, n] = dq(q_g[k, n]) =
// rnd_bf16(f32(q_g[k, n]) * scale[g * N + n]) from int8 / e4m3 bytes Q
// (bmap: q as (N, K, groups of B), uint8, box (BN, 64, 1) with the BN-byte
// swizzle: 16-byte chunk c of row k at chunk c ^ (k % 8) (BN 128) or
// c ^ (k / 2 % 4) (BN 64)), on BM x BN tiles (BN
// = 64 WG), and the K loop of iters = ceil(K / BK) * sum_groups iterations
// cut into slices of ks: CTA (x, y, z') takes slice z' / out_groups of
// output group z' % out_groups.  Warpgroup wg computes the transposed
// 64 x BM tile of output columns n0 + 64 wg.. by wgmma with the weights
// from registers (load_frag, one k16 step ahead of the products, two
// fragments in turn) and x's tile from the ring.  One slice: each sum
// rounded to bf16 once and stored; several: each CTA stores its f32
// partial tile into p (slices x out groups x M x p_ld) and the last of a
// tile's CTAs to take its ticket (tickets: one zeroed int32 an output
// tile, left zeroed) adds them in slice order, rounds once and stores.
template <int WG, int BM, typename Q>
__global__ void __launch_bounds__(threads<WG>(), WG == 1 ? 2 : 1)
chain_gemm_q_kernel(const __grid_constant__ CUtensorMap amap,
                    const __grid_constant__ CUtensorMap bmap,
                    const float* __restrict__ scale, bf16* __restrict__ c,
                    long long ldc, long long c_group, float* __restrict__ p,
                    long long p_ld, int* __restrict__ tickets, int M, int N,
                    int K, int out_groups, int sum_groups, int a_grouped,
                    int ks, int stages) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  constexpr int BN = 64 * WG, T = 128 * WG;
  constexpr int A_STAGE = BM * BK * 2, STAGE = q_stage_bytes<BM, BN>();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * STAGE);
  uint64_t* empty = full + stages;
  int* last = reinterpret_cast<int*>(empty + stages);
  const int kblocks = (K + BK - 1) / BK;
  const int iters = kblocks * sum_groups;
  const int slices = (iters + ks - 1) / ks;
  const int z = blockIdx.z % out_groups, q = blockIdx.z / out_groups;
  const int it0 = q * ks, n_it = min(iters, it0 + ks) - it0;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= T) {
    // the producer warp: one thread issues every load of the ring
    if (threadIdx.x == T) {
      prefetch_map(&amap);
      prefetch_map(&bmap);
      for (int i = 0; i < n_it; ++i) {
        const int s = i % stages, it = it0 + i;
        if (i >= stages) mbar_wait(&empty[s], (i / stages - 1) & 1);
        const int g = z + it / kblocks, k0 = (it % kblocks) * BK;
        unsigned char* st = smem + s * STAGE;
        mbar_expect_tx(&full[s], STAGE);
        tma_load_3d(st, &amap, &full[s], k0, a_grouped ? g : 0, m0);
        tma_load_3d(st + A_STAGE, &bmap, &full[s], n0, k0, g);
      }
    }
    return;
  }

  // a consumer warpgroup: output columns n0 + 64 wg .. + 64, rows m0 ..
  // + BM, transposed in its registers
  const int t = threadIdx.x, wg = t / 128, warp = (t % 128) / 32;
  const int lane = t % 32, gq = lane / 4, tq = lane % 4;
  const int nl = 64 * wg + 16 * warp + 2 * gq;  // the thread's column pair
  // its byte in rows 2 tq + (0, 1, 8, 9) of a k16 step: the swizzle's XOR
  // of the row's 16-byte chunks is 2 tq + (r & 1) (BN 128) or tq (BN 64)
  // for every step
  int wo[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 2 * tq + (r & 1) + 8 * (r >> 1);
    const int sw = BN == 128 ? 2 * tq + (r & 1) : tq;
    wo[r] = row * BN + (((nl >> 4) ^ sw) << 4) + (nl & 15);
  }
  float2 sc = make_float2(0.f, 0.f);
  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
  // a stage's four k16 fragments, in two sets used in turn: wgmma reads a
  // fragment's registers after its issue, so both sets stay live
  // (fence_frag) and one is only rewritten once the products that read it
  // are done
  uint32_t fa[16], fb[16];
  int s = 0, phase = 0;  // the ring stage of the current iteration
  // the scales of the thread's column pair in the branch of iteration it
  auto load_scales = [&](int it) {
    const float* row = scale + (long long)(z + it / kblocks) * N;
    const int n = n0 + nl;
    sc = make_float2(n < N ? __ldg(row + n) : 0.f,
                     n + 1 < N ? __ldg(row + n + 1) : 0.f);
  };
  // iteration i landed: its fragments into f, the scales of its branch
  // loaded where the branch starts (the slice's first, before the ring's
  // first stage lands)
  load_scales(it0);
  auto load_stage = [&](int i, uint32_t (&f)[16]) {
    mbar_wait(&full[s], phase);
    if (i > 0 && (it0 + i) % kblocks == 0) load_scales(it0 + i);
    const unsigned char* w = smem + s * STAGE + A_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      load_frag<Q>(w + kk * 16 * BN, wo, sc, f + 4 * kk);
  };
  // iteration i's products on fragments f, one commit group; then the
  // group before it done and its ring stage given back
  auto products = [&](int i, uint32_t (&f)[16]) {
    const uint32_t xt = smem_u32(smem + s * STAGE);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_rs<BM>(acc, f + 4 * kk, desc(xt + kk * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    fence_frag(fa);
    fence_frag(fb);
    if (i > 0 && t % 128 == 0)
      mbar_arrive(&empty[(s == 0 ? stages : s) - 1]);
  };
  auto next = [&]() {
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  };
  load_stage(0, fa);
  for (int i = 0; i < n_it; i += 2) {
    products(i, fa);
    if (i + 1 == n_it) break;
    next();
    load_stage(i + 1, fb);
    products(i + 1, fb);
    if (i + 2 == n_it) break;
    next();
    load_stage(i + 2, fa);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // accumulator d[4j + 2h + e]: output column n0 + nl + h, row m0 + 8j +
  // 2 tq + e
  const int n = n0 + nl;
  bf16* out = c + z * c_group;
  if (slices == 1) {
    store_pairs<BM>(acc, out, ldc, m0, n, tq, M, N);
    return;
  }
  // a sliced tile: this slice's f32 partial, then the ticket
  const long long plane = (long long)M * p_ld;
  const long long step_p = (long long)out_groups * plane;
  const float* tile_p = p + z * plane;
  if (n < N) {
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * tq + e;
        if (m < M)
          *reinterpret_cast<float2*>(p + q * step_p + z * plane +
                                     m * p_ld + n) =
              make_float2(acc[4 * j + e], acc[4 * j + 2 + e]);
      }
  }
  __threadfence();
  consumers_sync<T>();
  const int tile = (z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  if (t == 0) *last = atomicAdd(&tickets[tile], 1) == slices - 1;
  consumers_sync<T>();
  if (!*last) return;
  __threadfence();
  // the last CTA of the tile: the partials of slices 0, 1, ... added in
  // order, a slice's values loaded together
  if (n < N) {
    for (int s = 0; s < slices; ++s) {
      const float* src = tile_p + s * step_p + n;
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + 8 * j + 2 * tq + e;
          const float2 v =
              m < M ? __ldcg(reinterpret_cast<const float2*>(src + m * p_ld))
                    : make_float2(0.f, 0.f);
          acc[4 * j + e] = s == 0 ? v.x : acc[4 * j + e] + v.x;
          acc[4 * j + 2 + e] = s == 0 ? v.y : acc[4 * j + 2 + e] + v.y;
        }
    }
  }
  store_pairs<BM>(acc, out, ldc, m0, n, tq, M, N);
  if (t == 0) tickets[tile] = 0;
}

// The driver's tensor-map encoder (cuTensorMapEncodeTiled), fetched once
// through the runtime, so the library links no libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D tensor map of `type` values, dims (d0 innermost, d1, d2), byte
// strides s1, s2 (multiples of 16), boxes (b0, b1, b2), zeros past every
// edge: bf16 operands with the 128-byte swizzle wgmma reads, a quantized
// B's bytes (uint8) with the swizzle of its box's b0 bytes (64 or 128).
// False where the driver refuses it.
inline bool encode(CUtensorMap* map, const void* base, uint64_t d0,
                   uint64_t d1, uint64_t d2, uint64_t s1, uint64_t s2,
                   uint32_t b0, uint32_t b1, uint32_t b2,
                   CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t box[3] = {b0, b1, b2};
  const cuuint32_t step[3] = {1, 1, 1};
  const bool narrow = type == CU_TENSOR_MAP_DATA_TYPE_UINT8 && b0 == 64;
  return fn(map, type, 3, const_cast<void*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            narrow ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One launch of chain_gemm_kernel<BN, WG> (see there); the maps are encoded
// for this call (never cached by pointer: the allocator reuses addresses).
template <int BN, int WG>
int launch_gemm(const void* a, long long a_ld, long long a_group,
                int a_groups, const void* b, long long b_ld,
                long long b_group, int b_groups, void* c, long long ldc,
                long long c_group, int M, int N, int K, int out_groups,
                int sum_groups, int stages, cudaStream_t stream) {
  if (stages < 2 || stages > MAX_STAGES) return (int)cudaErrorInvalidValue;
  CUtensorMap amap, bmap;
  if (!encode(&amap, a, K, a_groups, M, a_group * 2, a_ld * 2, BK, 1,
              64 * WG) ||
      !encode(&bmap, b, N, K, b_groups, b_ld * 2, b_group * 2, 64, BK, 1))
    return (int)cudaErrorInvalidValue;
  auto kernel = chain_gemm_kernel<BN, WG>;
  // the deepest ring's shared memory, opted into once per device
  static unsigned long long opted = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !(opted >> dev & 1)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes<BN, WG>(MAX_STAGES));
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) opted |= 1ull << dev;
  }
  const dim3 grid((N + BN - 1) / BN, (M + 64 * WG - 1) / (64 * WG),
                  out_groups);
  kernel<<<grid, threads<WG>(), smem_bytes<BN, WG>(stages), stream>>>(
      amap, bmap, static_cast<bf16*>(c), ldc, c_group, M, N, K, sum_groups,
      a_groups > 1 ? 1 : 0, stages);
  return (int)cudaGetLastError();
}

// One launch of chain_gemm_q_kernel<WG, BM, Q> (see there): b holds the
// int8 / e4m3 bytes of B (strides in bytes), scale its f32 scales; K
// slices of ks iterations, the partials at p (rows of p_ld floats) and
// the tickets where there are several.
template <int WG, int BM, typename Q>
int launch_gemm_q(const void* a, long long a_ld, long long a_group,
                  int a_groups, const void* b, long long b_ld,
                  long long b_group, int b_groups, const float* scale,
                  void* c, long long ldc, long long c_group, float* p,
                  long long p_ld, int* tickets, int n_tickets, int M, int N,
                  int K, int out_groups, int sum_groups, int ks, int stages,
                  cudaStream_t stream) {
  constexpr int BN = 64 * WG;
  const long long iters = (long long)((K + BK - 1) / BK) * sum_groups;
  const int slices = ks > 0 ? (int)((iters + ks - 1) / ks) : 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, out_groups * slices);
  if (stages < 2 || stages > MAX_STAGES || slices <= 0 || scale == nullptr ||
      (long long)out_groups * slices > 65535 ||
      q_smem_bytes<BM, BN>(stages) > (size_t)SMEM_OPT_IN)
    return (int)cudaErrorInvalidValue;
  if (slices > 1 &&
      (p == nullptr || tickets == nullptr || p_ld < N || p_ld % 2 ||
       reinterpret_cast<uintptr_t>(p) % 8 ||
       (long long)grid.x * grid.y * out_groups > n_tickets))
    return (int)cudaErrorInvalidValue;
  CUtensorMap amap, bmap;
  if (!encode(&amap, a, K, a_groups, M, a_group * 2, a_ld * 2, BK, 1, BM) ||
      !encode(&bmap, b, N, K, b_groups, b_ld, b_group, BN, BK, 1,
              CU_TENSOR_MAP_DATA_TYPE_UINT8))
    return (int)cudaErrorInvalidValue;
  auto kernel = chain_gemm_q_kernel<WG, BM, Q>;
  static unsigned long long opted = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !(opted >> dev & 1)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_OPT_IN);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) opted |= 1ull << dev;
  }
  kernel<<<grid, threads<WG>(), q_smem_bytes<BM, BN>(stages), stream>>>(
      amap, bmap, scale, static_cast<bf16*>(c), ldc, c_group, p, p_ld,
      tickets, M, N, K, out_groups, sum_groups, a_groups > 1 ? 1 : 0, ks,
      stages);
  return (int)cudaGetLastError();
}

}  // namespace wgc
