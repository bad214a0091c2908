// The large-M form of the bf16 chain kernels (sm_90a): B1
//   y = rnd( rnd(x @ w0) @ w1 )                            (lowrank_matmul)
// and B2
//   y = rnd( sum_n rnd( rnd(x @ u_n) @ xc_n ) @ v_n )     (branched_matmul)
// over hundreds to thousands of activation rows (fine-tuning's M = 1,024,
// hubert's 2,000 frames, the VLM's 1,601 image tokens).  rnd is the cast
// to bf16; every product accumulates in f32, and B2's branch sum is taken
// in f32 and rounded once.
//
// Replaces, at M >= LARGE_M (kernels/branched_matmul.py), the TPU kernels
// src/repro/kernels/lowrank_matmul.py::lowrank_matmul (pallas_call at :68)
// and src/repro/kernels/branched_matmul.py::branched_matmul (:69), and,
// with chain_dequant.cu's pass writing their int8 / e4m3 factors as bf16
// into the scratch regions below first, lowrank_matmul_q.py::
// lowrank_matmul_q (:75) and branched_matmul_q.py::branched_matmul_q
// (:90): the same products, the same bits as B1 / B2 on the dequantized
// factors.  They
// keep h (B1) and each branch's h1 / h2 (B2) in VMEM per row block, to save
// the HBM round trip at M ~ 1e6.  Their roundings are kept exactly
// (lowrank_matmul.py:45-47, branched_matmul.py:37-39, 51-53).
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
// Design: every product of the chain is one launch of chain_gemm_kernel, an
// output-tiled GEMM, on the current stream, in order:
//   B1: h = rnd(x @ w0) into an (M, R) bf16 scratch; y = rnd(h @ w1);
//   B2: h1[:, n] = rnd(x @ u_n) for every branch n (one tile space over the
//       N*r1 columns: the tile's branch picks u_n); h2[:, n] = rnd(h1_n @
//       xc_n) (N grouped products in one tile space); y = rnd(h2 @ v), v
//       read as one (N*r2, S) matrix: the branch sum is the K loop, in f32,
//       rounded once.  B2's first two products are not fused: h1 goes
//       through the scratch (below) like h2.
// A CTA owns one BM x BN output tile (128 x 128; BN 64 where 128-wide
// tiles would leave SMs idle or pad a branch, and then BM 64 where the
// card is still not full) and loops over the whole K (and
// the branches of a summing product) inside the CTA: no K slices, no f32
// partials, no grid-wide sync.  One thread of a producer warp keeps a
// ring of 3-6 stages of A (128 x 64) and B (64 x BN) tiles in flight in
// shared memory, each a TMA load (cp.async.bulk.tensor, 128-byte swizzle,
// zeros past every edge: the ragged last row tile, a branch's last K
// block, a column tile past N) completing on the stage's mbarrier.  One
// consumer warpgroup a 64-row half runs wgmma.mma_async m64nBNk16 (bf16
// in, f32 in registers) from the ring, A K-major and B MN-major (the
// factors are stored (K, N), row-major); each keeps one wgmma group in
// flight and releases the stage before it.  Where a product has more
// tiles than the card has SMs, the ring is 3-4 stages deep and two CTAs
// (288 threads each) share an SM, so one's prologue and epilogue overlap
// the other's products; else it is 6 deep, one CTA an SM.  The epilogue
// rounds each f32 sum to bf16 once and stores it straight from the
// registers, clipped to (M, N).
// Products run in order as separate launches: a tile of phase k+1 reads
// whole rows of phase k's output, and the stream orders them without a
// grid-wide sync (a persistent launch with per-row-block counters would
// save the 2-5 us between launches; not done).  No atomics: a call gives
// the same bits every run.
//
// The scratch round trip: h (B1) and h1, h2 (B2) go through device memory,
// at most R / C of x's bytes (hubert: 2,000 x 256 bf16 = 1 MB against x's
// 5 MB); written by one launch and read by the next, they stay in the
// 50 MB L2, so they cost neither HBM bandwidth nor the bound above.
// Operands whose row is not a whole number of 16-byte granules (TMA's
// stride rule: the searched k/v rank 191), or whose base is not 16-byte
// aligned, are copied by the wrapper into zero-padded rows of the scratch
// first; the intermediates are laid out padded from the start.  B3 / B4's
// quantized factors always take such a region, written by the pass.
#pragma once

// CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda.h>
#include <cuda_bf16.h>
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

// A 3-D bf16 tensor map of dims (d0 innermost, d1, d2), byte strides s1,
// s2 (multiples of 16), boxes (b0, b1, b2), 128-byte swizzle, zeros past
// every edge.  False where the driver refuses it.
inline bool encode(CUtensorMap* map, const void* base, uint64_t d0,
                   uint64_t d1, uint64_t d2, uint64_t s1, uint64_t s2,
                   uint32_t b0, uint32_t b1, uint32_t b2) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t box[3] = {b0, b1, b2};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
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

}  // namespace wgc
